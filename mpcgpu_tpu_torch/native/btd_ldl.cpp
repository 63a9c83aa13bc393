// Block-tridiagonal LDL^T direct solver (CPU).
//
// Native counterpart of the reference's qdldl path: the reference ships the
// Schur complement's lower triangle to the host each SQP iteration and
// factorizes with osqp/qdldl (include/qdldl/sqp.cuh:22-49, :268-273).  This
// implementation exploits the block-tridiagonal structure directly (block
// LDL^T with dense n x n blocks) instead of a generic sparse LDL^T — the
// role it plays in the framework is identical: a CPU direct-solve baseline
// used to cross-check the on-device iterative solver.
//
// Layout: theta[N][n][n] row-major diagonal blocks, phi[N-1][n][n] row-major
// sub-diagonal blocks (block (k+1, k)), b[N][n] rhs.  Solves S x = b where
// S = blocktridiag(phi, theta, phi^T).  Returns 0 on success, -1 if a
// diagonal pivot collapses.

#include <cstring>
#include <vector>

namespace {

// In-place Gauss-Jordan inverse without pivoting (blocks are SPD after
// rho-regularization; same assumption as reference utils/matrix.cuh:120-148).
int invert(double* a, int n, double* work) {
  // work: n*2n augmented buffer
  for (int r = 0; r < n; ++r) {
    for (int c = 0; c < n; ++c) {
      work[r * 2 * n + c] = a[r * n + c];
      work[r * 2 * n + n + c] = (r == c) ? 1.0 : 0.0;
    }
  }
  for (int p = 0; p < n; ++p) {
    double pv = work[p * 2 * n + p];
    if (pv == 0.0) return -1;
    double inv = 1.0 / pv;
    for (int c = 0; c < 2 * n; ++c) work[p * 2 * n + c] *= inv;
    for (int r = 0; r < n; ++r) {
      if (r == p) continue;
      double f = work[r * 2 * n + p];
      if (f == 0.0) continue;
      for (int c = 0; c < 2 * n; ++c) work[r * 2 * n + c] -= f * work[p * 2 * n + c];
    }
  }
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c) a[r * n + c] = work[r * 2 * n + n + c];
  return 0;
}

void matmul(const double* a, const double* b, double* c, int n, bool tb) {
  // c = a @ b (or a @ b^T if tb), all n x n row-major
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      double s = 0.0;
      for (int k = 0; k < n; ++k)
        s += a[i * n + k] * (tb ? b[j * n + k] : b[k * n + j]);
      c[i * n + j] = s;
    }
}

void matvec(const double* a, const double* x, double* y, int n, bool ta) {
  for (int i = 0; i < n; ++i) {
    double s = 0.0;
    for (int k = 0; k < n; ++k) s += (ta ? a[k * n + i] : a[i * n + k]) * x[k];
    y[i] = s;
  }
}

}  // namespace

extern "C" int btd_ldl_solve(int n, int N, const double* theta,
                             const double* phi, const double* b, double* x) {
  const int nn = n * n;
  std::vector<double> Dinv(static_cast<size_t>(N) * nn);   // D_k^{-1}
  std::vector<double> L(static_cast<size_t>(N > 1 ? N - 1 : 0) * nn);
  std::vector<double> work(2 * nn), tmp(nn), y(static_cast<size_t>(N) * n);

  // factor: D_0 = theta_0; L_k = phi_k D_{k-1}^{-1}; D_k = theta_k - L_k phi_k^T
  std::memcpy(Dinv.data(), theta, sizeof(double) * nn);
  if (invert(Dinv.data(), n, work.data())) return -1;
  for (int k = 1; k < N; ++k) {
    matmul(phi + (k - 1) * nn, Dinv.data() + (k - 1) * nn, L.data() + (k - 1) * nn, n, false);
    matmul(L.data() + (k - 1) * nn, phi + (k - 1) * nn, tmp.data(), n, true);
    double* Dk = Dinv.data() + k * nn;
    for (int i = 0; i < nn; ++i) Dk[i] = theta[k * nn + i] - tmp[i];
    if (invert(Dk, n, work.data())) return -1;
  }

  // forward: y_0 = b_0; y_k = b_k - L_k y_{k-1}
  std::memcpy(y.data(), b, sizeof(double) * n);
  for (int k = 1; k < N; ++k) {
    matvec(L.data() + (k - 1) * nn, y.data() + (k - 1) * n, tmp.data(), n, false);
    for (int i = 0; i < n; ++i) y[k * n + i] = b[k * n + i] - tmp[i];
  }

  // diagonal + backward: x_k = D_k^{-1} y_k - L_{k+1}^T x_{k+1}
  matvec(Dinv.data() + (N - 1) * nn, y.data() + (N - 1) * n, x + (N - 1) * n, n, false);
  for (int k = N - 2; k >= 0; --k) {
    matvec(Dinv.data() + k * nn, y.data() + k * n, x + k * n, n, false);
    matvec(L.data() + k * nn, x + (k + 1) * n, tmp.data(), n, true);
    for (int i = 0; i < n; ++i) x[k * n + i] -= tmp[i];
  }
  return 0;
}
