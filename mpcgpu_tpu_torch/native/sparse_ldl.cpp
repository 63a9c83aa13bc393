// Sparse elimination-tree LDL^T for quasi-definite matrices (CPU).
//
// Native counterpart of the reference's direct path: the reference host-
// factorizes the Schur complement each SQP iteration with osqp/qdldl's
// QDLDL_etree / QDLDL_factor / QDLDL_solve (include/qdldl/sqp.cuh:22-49,
// :193, :271), consuming the upper triangle in CSC form produced by its CSR
// packer (include/utils/csr.cuh:40-74).  This file implements the same
// three-stage API from scratch: the classic up-looking LDL^T with an
// elimination-tree symbolic pass (no pivoting — the rho-regularized Schur
// complement is quasi-definite, the same assumption qdldl makes).
//
// Input: upper-triangular CSC (Ap column pointers, Ai row indices sorted
// ascending per column, diagonal entry present and last in its column —
// exactly what ops/csr.py::btd_upper_csc_pattern emits).
// Output: L strictly lower-triangular CSC + diagonal D (and 1/D).
//
// All integer arguments are int64 to keep the ctypes surface simple.

#include <cstdint>

extern "C" {

// Symbolic pass: elimination tree + column counts of L.
// work: 1n scratch.  Returns nnz(L) (>= 0), or -1 if the pattern is not
// upper-triangular-with-diagonal as required.
int64_t sldl_etree(int64_t n, const int64_t* Ap, const int64_t* Ai,
                   int64_t* work, int64_t* Lnz, int64_t* etree) {
  for (int64_t i = 0; i < n; ++i) {
    work[i] = 0;
    Lnz[i] = 0;
    etree[i] = -1;
  }
  for (int64_t j = 0; j < n; ++j) {
    work[j] = j;  // flag: column j has been touched in this step
    if (Ap[j + 1] <= Ap[j]) return -1;  // empty column: no diagonal
    for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
      int64_t i = Ai[p];
      if (i > j) return -1;  // entry below the diagonal
      while (work[i] != j) {  // walk up the partial etree
        if (etree[i] == -1) etree[i] = j;
        Lnz[i]++;             // L[j, i] != 0  (one entry in column i of L)
        work[i] = j;
        i = etree[i];
      }
    }
  }
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) total += Lnz[i];
  return total;
}

// Numeric pass (up-looking, one column of L per outer step).
// iwork: 3n scratch; bwork: n scratch (0/1 marks); fwork: n scratch.
// Returns the number of positive diagonal entries, or -1 on a zero pivot.
int64_t sldl_factor(int64_t n, const int64_t* Ap, const int64_t* Ai,
                    const double* Ax, int64_t* Lp, int64_t* Li, double* Lx,
                    double* D, double* Dinv, const int64_t* Lnz,
                    const int64_t* etree, int64_t* iwork, int64_t* bwork,
                    double* fwork) {
  int64_t pos_count = 0;
  // column pointers of L from the symbolic counts; next-free cursors
  int64_t* next = iwork;             // n: next write slot per column of L
  int64_t* e_stack = iwork + n;      // n: etree path stack
  int64_t* touched = iwork + 2 * n;  // n: list of touched columns
  Lp[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    Lp[i + 1] = Lp[i] + Lnz[i];
    next[i] = Lp[i];
    bwork[i] = 0;
    fwork[i] = 0.0;
  }
  for (int64_t j = 0; j < n; ++j) {
    // scatter column j of A (upper part) into the dense work vector
    D[j] = 0.0;
    int64_t ntouched = 0;
    for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
      int64_t i = Ai[p];
      if (i == j) {
        D[j] = Ax[p];
        continue;
      }
      fwork[i] = Ax[p];
      // record the etree path from i toward j in topological order
      int64_t top = 0;
      int64_t node = i;
      while (!bwork[node]) {
        bwork[node] = 1;
        e_stack[top++] = node;
        node = etree[node];
        if (node == -1 || node >= j) break;
      }
      // pop in reverse so ancestors come after descendants in `touched`
      while (top > 0) touched[ntouched++] = e_stack[--top];
    }
    // `touched` holds the pattern of row j of L in reverse-topological
    // chunks; process in the order columns were completed (ascending
    // column index guarantees L's columns i < j are final).  Sort-free:
    // process by increasing column index via simple insertion over the
    // touched list (its size is the row nnz, small for banded systems).
    for (int64_t a = 1; a < ntouched; ++a) {
      int64_t v = touched[a];
      int64_t b = a - 1;
      while (b >= 0 && touched[b] > v) {
        touched[b + 1] = touched[b];
        --b;
      }
      touched[b + 1] = v;
    }
    for (int64_t t = 0; t < ntouched; ++t) {
      int64_t i = touched[t];
      bwork[i] = 0;
      double yi = fwork[i];
      fwork[i] = 0.0;
      // apply column i of L to the work vector (rows > i)
      for (int64_t p = Lp[i]; p < next[i]; ++p) {
        fwork[Li[p]] -= Lx[p] * yi;
      }
      double lji = yi * Dinv[i];
      D[j] -= lji * yi;
      Li[next[i]] = j;  // L[j, i]
      Lx[next[i]] = lji;
      next[i]++;
    }
    if (D[j] == 0.0) return -1;
    if (D[j] > 0.0) pos_count++;
    Dinv[j] = 1.0 / D[j];
  }
  return pos_count;
}

// In-place solve of L D L^T x = b (x holds b on entry, the solution on
// exit).  L is strictly-lower CSC as produced by sldl_factor.
void sldl_solve(int64_t n, const int64_t* Lp, const int64_t* Li,
                const double* Lx, const double* Dinv, double* x) {
  for (int64_t i = 0; i < n; ++i) {  // L z = b (unit diagonal)
    double xi = x[i];
    for (int64_t p = Lp[i]; p < Lp[i + 1]; ++p) x[Li[p]] -= Lx[p] * xi;
  }
  for (int64_t i = 0; i < n; ++i) x[i] *= Dinv[i];
  for (int64_t i = n - 1; i >= 0; --i) {  // L^T x = z
    double xi = x[i];
    for (int64_t p = Lp[i]; p < Lp[i + 1]; ++p) xi -= Lx[p] * x[Li[p]];
    x[i] = xi;
  }
}

}  // extern "C"
