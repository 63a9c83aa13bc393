// K1: KKT assembly + Schur condensation + symmetric-stair preconditioner;
// K5: the KKT blocks alone.
//
// K1 replaces the TPU kernel mpcgpu_tpu/solver/kkt_pallas.py::
// build_kkt_schur_pallas (_make_kkt_schur_kernel, core _kkt_core).  Per knot
// k it linearizes the dynamics (forward-mode RNEA with 14 tangents, CRBA mass
// matrix and its Gauss-Jordan inverse, Euler / semi-implicit Jacobians),
// builds the Gauss-Newton ee-tracking cost with (Q + rho I)^{-1} in closed
// form (Sherman-Morrison), and forms the Schur blocks theta/phi/gamma and the
// 3-band stair preconditioner, in the knot-leading layout of
// mpcgpu_tpu_torch/ops/schur.py.
//
// What bounds it on an H100: latency, not bytes.  Each knot is a chain of
// tiny serial 6x6 / 14x14 products (~100 KFLOP) and the outputs are ~300 KB
// at N = 64, so the time is the depth of the dependent steps and the block
// syncs between them, on 64 of 132 SMs.  The design spreads each step over
// a block's threads (one matrix entry or one tangent direction per thread)
// and splits the knot coupling into three launches on one stream:
//   A  one block per knot: everything local to knot k, plus the pieces its
//      neighbour needs (T = A Qinv A^T + B Rinv B^T, A Qinv, xnext, A Qinv q,
//      B Rinv r) into a scratch buffer;
//   B  one block per knot: theta_k, phi_k, phi_k^T and gamma_k from knot k-1's
//      scratch, and D_k = theta_k^{-1} by Gauss-Jordan;
//   C  one block per knot: the stair bands -D_k S_{k,k+-1} D_{k+-1}, which
//      need the neighbours' D (a two-hop dependency on T).
// The lane rolls of the TPU kernel become explicit neighbour indices with
// bounds: gamma_0 leaves out c_0, row 0 has no phi, the last row no phi^T,
// the stair bands are zero at the edges.  A and B at the last knot are not
// part of the QP and are written as zeros.
//
// K5 replaces mpcgpu_tpu/solver/kkt_pallas.py::build_kkt_pallas
// (_make_kkt_kernel, the same _kkt_core).  It is launch A's per-knot code with
// the Schur tail compiled out (knot_kernel<false>): per knot it writes the
// Gauss-Newton Q = [[gq gq^T, 0], [0, qd_cost I]], q, A, B and the defect
// c_{k+1} = x_{k+1} - f(x_k, u_k) (block 0 also c_0 = x_0 - xs), and needs no
// rho, no inverse and no neighbour, so one launch.  Latency-bound like A.
//
// K8a replaces mpcgpu_tpu/parallel/batched_fused.py::build_kkt_schur_batched
// (K1 over instance groups packed on lanes).  It is K1's three launches over
// a (knot, instance) grid: instance blockIdx.y offsets its rows of xu and
// the goal, reads its own rho and writes its own (N, ...) slab of every
// output, so each instance's result is K1's bit for bit.  B instances give
// B x N blocks per launch, which fill the card where K1's N blocks do not.
//
// K9a replaces mpcgpu_tpu/solver/kkt_pallas.py::build_kkt_schur_pallas_slab
// (_make_kkt_schur_kernel with boundary_masks=True), the shard-local kernel
// of the knot-sharded SQP.  It is K1's three launches over a (knot, shard)
// grid, each shard a window of Lext = L + 4 knots of the horizon (its own L
// and two halo knots per side: the stair band at a slab's first knot needs
// D of the knot before it, which needs T two knots back).  Where K1 tests
// k == 0 and k == N - 1, K9a also reads two runtime flags per knot, the
// GLOBAL first and last knot, so a knot at either end of the window or at
// an end of the horizon takes the same branch; the caller keeps the L
// interior knots, which are then K1's rows bit for bit.  Bound as K1.
#include "common.cuh"

using namespace mpc;

namespace {

constexpr int NN = NX * NX;                  // 196
constexpr int SCR = 2 * NN + 3 * NX;         // T, AQ, xnext, aqq, brr

// Knot k at the start / end of the horizon.  Without flags (K1, K5, K8a)
// the launch's N knots are the horizon; with them (K9a) bm points at the
// window's global-first flags bm[0..N) and global-last flags bm[N..2N), and
// the window's own ends count as ends too (no neighbour in the window).
__device__ inline bool first_knot(const float* bm, int k) {
  return k == 0 || (bm != nullptr && bm[k] != 0.f);
}
__device__ inline bool last_knot(const float* bm, int N, int k) {
  return k == N - 1 || (bm != nullptr && bm[N + k] != 0.f);
}

// Forward-mode RNEA with one tangent direction t (t < NQ: d/dq_t;
// NQ <= t < NX: d/dqd_{t-NQ}; t < 0: value only).  X/Xp hold the knot's
// transforms and their q-derivatives; qdd == nullptr gives the bias term.
__device__ void rnea_dual(const float* X, const float* Xp, const float* I,
                          const float* qd, const float* qdd, int t,
                          float gravity, float* tau, float* tau_dot) {
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, vd[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float a[6] = {0.f, 0.f, 0.f, 0.f, 0.f, gravity}, ad[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float f[NQ][6], fd[NQ][6];
  for (int k = 0; k < NQ; ++k) {
    const float* Xk = X + k * M66;
    const float* Xpk = Xp + k * M66;
    const float dqd = (t == NQ + k) ? 1.f : 0.f;
    float vn[6], vdn[6], an[6], adn[6], tmp[6];
    mv6(Xk, v, vn);
    mv6(Xk, vd, vdn);
    mv6(Xk, a, an);
    mv6(Xk, ad, adn);
    if (t == k) {
      mv6(Xpk, v, tmp);
      for (int i = 0; i < 6; ++i) vdn[i] += tmp[i];
      mv6(Xpk, a, tmp);
      for (int i = 0; i < 6; ++i) adn[i] += tmp[i];
    }
    vn[2] += qd[k];
    vdn[2] += dqd;
    cross_ez_add(vn, qd[k], an);
    cross_ez_add(vdn, qd[k], adn);
    cross_ez_add(vn, dqd, adn);
    if (qdd != nullptr) an[2] += qdd[k];
    const float* Ik = I + k * M66;
    float Iv[6], Ivd[6];
    mv6(Ik, vn, Iv);
    mv6(Ik, vdn, Ivd);
    mv6(Ik, an, f[k]);
    crf_add(vn, Iv, f[k]);
    mv6(Ik, adn, fd[k]);
    crf_add(vdn, Iv, fd[k]);
    crf_add(vn, Ivd, fd[k]);
    for (int i = 0; i < 6; ++i) {
      v[i] = vn[i];
      vd[i] = vdn[i];
      a[i] = an[i];
      ad[i] = adn[i];
    }
  }
  float fc[6], fcd[6];
  for (int i = 0; i < 6; ++i) {
    fc[i] = f[NQ - 1][i];
    fcd[i] = fd[NQ - 1][i];
  }
  for (int k = NQ - 1; k >= 0; --k) {
    tau[k] = fc[2];
    tau_dot[k] = fcd[2];
    if (k > 0) {
      float n[6], nd[6], tmp[6];
      mv6t(X + k * M66, fc, n);
      mv6t(X + k * M66, fcd, nd);
      if (t == k) {
        mv6t(Xp + k * M66, fc, tmp);
        for (int i = 0; i < 6; ++i) nd[i] += tmp[i];
      }
      for (int i = 0; i < 6; ++i) {
        fc[i] = f[k - 1][i] + n[i];
        fcd[i] = fd[k - 1][i] + nd[i];
      }
    }
  }
}

// End-effector position and its derivative in q_t (product rule along the
// homogeneous chain).
__device__ void fk_dual(const float* m, const float* s, const float* c, int t,
                        float* ee, float* jcol) {
  float T[16], Td[16], H[16], Hp[16], n[16], nd[16];
  hmat(m, 0, s[0], c[0], T);
  if (t == 0) hmat_d(m, 0, s[0], c[0], Td);
  else for (int e = 0; e < 16; ++e) Td[e] = 0.f;
  for (int j = 1; j < NQ; ++j) {
    hmat(m, j, s[j], c[j], H);
    mm4(T, H, n);
    mm4(Td, H, nd);
    if (t == j) {
      hmat_d(m, j, s[j], c[j], Hp);
      mm4(T, Hp, Td);
      for (int e = 0; e < 16; ++e) nd[e] += Td[e];
    }
    for (int e = 0; e < 16; ++e) {
      T[e] = n[e];
      Td[e] = nd[e];
    }
  }
  ee[0] = T[3];
  ee[1] = T[7];
  ee[2] = T[11];
  jcol[0] = Td[3];
  jcol[1] = Td[7];
  jcol[2] = Td[11];
}

// kSchur: launch A of K1 (Q_o gets (Q + rho I)^{-1}, scr the neighbour
// scratch).  !kSchur: K5 (Q_o gets Q, scr the defects c (N, NX); rho_p is
// not read, xs is read by block 0).  bmask: K9a's knot flags (2 N per
// shard) or nullptr.
template <bool kSchur>
__global__ void __launch_bounds__(256)
knot_kernel(const float* __restrict__ xu, int xu_stride, int xu_bstride,
            const float* __restrict__ goal, int goal_stride, int goal_bstride,
            const float* __restrict__ xs, const float* __restrict__ rho_p,
            int rho_bstride, const float* __restrict__ bmask,
            float dt, const float* __restrict__ model, float gravity,
            float qd_cost, float r_cost, int N, int integrator_type, int wrap,
            int terminal_at_last, float* __restrict__ Q_o,
            float* __restrict__ A_o, float* __restrict__ B_o,
            float* __restrict__ q_o, float* __restrict__ scr) {
  const int k = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  // instance or shard blockIdx.y (K8a, K9a): its own rows, rho and outputs
  const int b = blockIdx.y;
  xu += (size_t)b * xu_bstride;
  goal += (size_t)b * goal_bstride;
  const float* bm = bmask != nullptr ? bmask + (size_t)b * 2 * N : nullptr;
  const bool last = last_knot(bm, N, k);
  Q_o += (size_t)b * N * NN;
  A_o += (size_t)b * N * NN;
  B_o += (size_t)b * N * NX * NU;
  q_o += (size_t)b * N * NX;
  scr += (size_t)b * N * (kSchur ? SCR : NX);
  __shared__ float sm[MODEL_SIZE];
  __shared__ float x[NX], u[NU], xe[NX], gl[3], sq[NQ], cq[NQ], se[NQ], ce[NQ];
  __shared__ float X[NQ * M66], Xp[NQ * M66], IC[NQ * M66], t36[M66];
  __shared__ float aug[NQ * 2 * NQ], piv[2 * NQ], fcol[NQ];
  __shared__ float Minv[NQ * NQ], cbias[NQ], qdd[NQ], dID[NQ * NX], dqdd[NQ * NX];
  __shared__ float A[NN], B[NX * NU], Qi[NN], AQ[NN], grad[NX], xn[NX];
  __shared__ float ee[3], J[3 * NQ];

  load_model(sm, model);
  // the reference's terminal quirk: the last knot's cost at x_{N-2}
  const int ke = (last && !terminal_at_last && k > 0) ? k - 1 : k;
  for (int i = tid; i < NX; i += nth) {
    x[i] = xu[k * xu_stride + i];
    xe[i] = xu[ke * xu_stride + i];
  }
  for (int i = tid; i < NU; i += nth) u[i] = xu[k * xu_stride + NX + i];
  if (tid < 3) gl[tid] = goal[k * goal_stride + tid];
  __syncthreads();
  if (tid < NQ) {
    sq[tid] = sinf(x[tid]);
    cq[tid] = cosf(x[tid]);
    se[tid] = sinf(xe[tid]);
    ce[tid] = cosf(xe[tid]);
  }
  __syncthreads();
  for (int e = tid; e < NQ * M66; e += nth) {
    const int j = e / M66;
    const float s = sq[j], c = cq[j];
    const float b = sm[OFF_XS + e], d = sm[OFF_XCOS + e];
    X[e] = sm[OFF_XC + e] + s * b + c * d;
    Xp[e] = c * b - s * d;
    IC[e] = sm[OFF_I + e];
  }
  // CRBA composite inertias: IC_{j-1} += X_j^T IC_j X_j
  for (int j = NQ - 1; j > 0; --j) {
    __syncthreads();
    if (tid < M66) {
      const int r = tid / 6, c = tid % 6;
      float acc = 0.f;
      for (int l = 0; l < 6; ++l) acc += X[j * M66 + l * 6 + r] * IC[j * M66 + l * 6 + c];
      t36[tid] = acc;
    }
    __syncthreads();
    if (tid < M66) {
      const int r = tid / 6, c = tid % 6;
      float acc = 0.f;
      for (int l = 0; l < 6; ++l) acc += t36[r * 6 + l] * X[j * M66 + l * 6 + c];
      IC[(j - 1) * M66 + tid] += acc;
    }
  }
  __syncthreads();
  // column j of M: M[i][j] = e_z^T X_{i+1}^T .. X_j^T IC_j e_z for i <= j
  if (tid < NQ) {
    const int j = tid;
    float v[6], w[6];
    for (int i = 0; i < 6; ++i) v[i] = IC[j * M66 + i * 6 + 2];
    aug[j * 2 * NQ + j] = v[2];
    for (int i = j - 1; i >= 0; --i) {
      mv6t(X + (i + 1) * M66, v, w);
      for (int l = 0; l < 6; ++l) v[l] = w[l];
      aug[i * 2 * NQ + j] = v[2];
      aug[j * 2 * NQ + i] = v[2];
    }
    for (int i = 0; i < NQ; ++i) aug[j * 2 * NQ + NQ + i] = i == j ? 1.f : 0.f;
  }
  gj_block(aug, NQ, 2 * NQ, piv, fcol);
  for (int e = tid; e < NQ * NQ; e += nth)
    Minv[e] = aug[(e / NQ) * 2 * NQ + NQ + e % NQ];
  // bias term (thread 0) and the ee Jacobian at x_eval (one warp, one
  // column per thread), side by side
  if (tid == 0) {
    float tmp[NQ];
    rnea_dual(X, Xp, sm + OFF_I, x + NQ, nullptr, -1, gravity, cbias, tmp);
  } else if (tid >= 32 && tid < 32 + NQ) {
    float e3[3], jc[3];
    fk_dual(sm, se, ce, tid - 32, e3, jc);
    for (int r = 0; r < 3; ++r) J[r * NQ + tid - 32] = jc[r];
    if (tid == 32) for (int r = 0; r < 3; ++r) ee[r] = e3[r];
  }
  __syncthreads();
  if (tid < NQ) {
    float acc = 0.f;
    for (int j = 0; j < NQ; ++j) acc += Minv[tid * NQ + j] * (u[j] - cbias[j]);
    qdd[tid] = acc;
    float g = 0.f;
    for (int r = 0; r < 3; ++r) g += J[r * NQ + tid] * (ee[r] - gl[r]);
    grad[tid] = g;
  } else if (tid < NX) {
    grad[tid] = qd_cost * xe[tid];
  }
  __syncthreads();
  // dID/d{q, qd} at the solved qdd: one tangent direction per thread
  if (tid < NX) {
    float tau[NQ], td[NQ];
    rnea_dual(X, Xp, sm + OFF_I, x + NQ, qdd, tid, gravity, tau, td);
    for (int i = 0; i < NQ; ++i) dID[i * NX + tid] = td[i];
  }
  __syncthreads();
  for (int e = tid; e < NQ * NX; e += nth) {
    const int i = e / NX, t = e - i * NX;
    float acc = 0.f;
    for (int j = 0; j < NQ; ++j) acc += Minv[i * NQ + j] * dID[j * NX + t];
    dqdd[e] = -acc;
  }
  __syncthreads();
  const float rho = kSchur ? rho_p[(size_t)b * rho_bstride] : 0.f;
  for (int e = tid; e < NN; e += nth) {
    const int r = e / NX, c = e - r * NX;
    const float eye = r == c ? 1.f : 0.f;
    float val;
    if (r >= NQ) {
      const float dd = dqdd[(r - NQ) * NX + c];
      val = c < NQ ? dt * dd : eye + dt * dd;
    } else if (integrator_type == 0) {
      val = eye + (c == r + NQ ? dt : 0.f);
    } else {
      const float dd = dqdd[r * NX + c];
      val = c < NQ ? eye + dt * dt * dd : (c == r + NQ ? dt : 0.f) + dt * dt * dd;
    }
    A[e] = val;
  }
  for (int e = tid; e < NX * NU; e += nth) {
    const int r = e / NU, c = e - r * NU;
    if (r >= NQ) B[e] = dt * Minv[(r - NQ) * NQ + c];
    else B[e] = integrator_type == 0 ? 0.f : dt * dt * Minv[r * NQ + c];
  }
  if (tid == 0) integrate(x, x + NQ, qdd, dt, integrator_type, wrap, xn);
  if constexpr (!kSchur) {
    __syncthreads();
    for (int e = tid; e < NN; e += nth) {
      const int r = e / NX, c = e - r * NX;
      float val = 0.f;
      if (r < NQ && c < NQ) val = grad[r] * grad[c];
      else if (r == c && r >= NQ) val = qd_cost;
      Q_o[(size_t)k * NN + e] = val;
      A_o[(size_t)k * NN + e] = k < N - 1 ? A[e] : 0.f;
    }
    for (int e = tid; e < NX * NU; e += nth)
      B_o[(size_t)k * NX * NU + e] = k < N - 1 ? B[e] : 0.f;
    if (tid < NX) {
      q_o[k * NX + tid] = grad[tid];
      if (k < N - 1) scr[(k + 1) * NX + tid] = xu[(k + 1) * xu_stride + tid] - xn[tid];
      if (k == 0) scr[tid] = x[tid] - xs[tid];
    }
    return;
  }
  // (Q + rho I)^{-1} in closed form: Q = [[gq gq^T, 0], [0, qd_cost I]], so
  // (rho I + gq gq^T)^{-1} = (1/rho)(I - gq gq^T / (rho + |gq|^2))
  {
    float gq2 = 0.f;
    for (int i = 0; i < NQ; ++i) gq2 += grad[i] * grad[i];
    const float inv_rho = 1.f / rho;
    const float smc = inv_rho / (rho + gq2);
    const float s_qd = 1.f / (qd_cost + rho);
    for (int e = tid; e < NN; e += nth) {
      const int r = e / NX, c = e - r * NX;
      float val = 0.f;
      if (r < NQ && c < NQ) val = (r == c ? inv_rho : 0.f) - smc * (grad[r] * grad[c]);
      else if (r == c) val = s_qd;
      Qi[e] = val;
    }
  }
  __syncthreads();
  for (int e = tid; e < NN; e += nth) {
    const int r = e / NX, c = e - r * NX;
    float acc = 0.f;
    for (int j = 0; j < NX; ++j) acc += A[r * NX + j] * Qi[j * NX + c];
    AQ[e] = acc;
  }
  __syncthreads();
  const float s_r = 1.f / (r_cost + rho);
  float* out = scr + (size_t)k * SCR;
  for (int e = tid; e < NN; e += nth) {
    const int r = e / NX, c = e - r * NX;
    float aqa = 0.f, bb = 0.f;
    for (int j = 0; j < NX; ++j) aqa += AQ[r * NX + j] * A[c * NX + j];
    for (int j = 0; j < NU; ++j) bb += B[r * NU + j] * B[c * NU + j];
    out[e] = aqa + s_r * bb;                        // T
    out[NN + e] = AQ[e];
    Q_o[(size_t)k * NN + e] = Qi[e];
    A_o[(size_t)k * NN + e] = last ? 0.f : A[e];
  }
  for (int e = tid; e < NX * NU; e += nth)
    B_o[(size_t)k * NX * NU + e] = last ? 0.f : B[e];
  if (tid < NX) {
    float aqq = 0.f, bu = 0.f;
    for (int j = 0; j < NX; ++j) aqq += AQ[tid * NX + j] * grad[j];
    for (int j = 0; j < NU; ++j) bu += B[tid * NU + j] * (r_cost * u[j]);
    out[2 * NN + tid] = xn[tid];
    out[2 * NN + NX + tid] = aqq;
    out[2 * NN + 2 * NX + tid] = s_r * bu;
    q_o[k * NX + tid] = grad[tid];
  }
}

__global__ void __launch_bounds__(256)
schur_kernel(const float* __restrict__ xu, int xu_stride, int xu_bstride,
             const float* __restrict__ Qinv, const float* __restrict__ q,
             const float* __restrict__ scr, const float* __restrict__ bmask,
             int N, float* __restrict__ S, float* __restrict__ Pinv,
             float* __restrict__ gamma) {
  const int k = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int b = blockIdx.y;
  const float* bm = bmask != nullptr ? bmask + (size_t)b * 2 * N : nullptr;
  const bool has_prev = !first_knot(bm, k), has_next = !last_knot(bm, N, k);
  xu += (size_t)b * xu_bstride;
  Qinv += (size_t)b * N * NN;
  q += (size_t)b * N * NX;
  scr += (size_t)b * N * SCR;
  S += (size_t)b * N * 3 * NN;
  Pinv += (size_t)b * N * 3 * NN;
  gamma += (size_t)b * N * NX;
  __shared__ float aug[NX * 2 * NX], piv[2 * NX], fcol[NX];
  const float* prev = scr + (size_t)(k - 1) * SCR;   // valid if has_prev
  const float* cur = scr + (size_t)k * SCR;
  const float* Qk = Qinv + (size_t)k * NN;
  float* Sk = S + (size_t)k * 3 * NN;
  for (int e = tid; e < NN; e += nth) {
    const int r = e / NX, c = e - r * NX;
    const float theta = has_prev ? Qk[e] + prev[e] : Qk[e];
    Sk[e] = has_prev ? -prev[NN + e] : 0.f;                  // phi_k
    Sk[NN + e] = theta;
    Sk[2 * NN + e] = has_next ? -cur[NN + c * NX + r] : 0.f;  // phi_{k+1}^T
    aug[r * 2 * NX + c] = theta;
    aug[r * 2 * NX + NX + c] = r == c ? 1.f : 0.f;
  }
  if (tid < NX) {
    float g = 0.f;
    for (int j = 0; j < NX; ++j) g += Qk[tid * NX + j] * q[k * NX + j];
    if (has_prev) {
      const float ck = xu[k * xu_stride + tid] - prev[2 * NN + tid];
      g = ((g - ck) - prev[2 * NN + NX + tid]) - prev[2 * NN + 2 * NX + tid];
    }
    gamma[k * NX + tid] = g;
  }
  gj_block(aug, NX, 2 * NX, piv, fcol);
  for (int e = tid; e < NN; e += nth) {
    const int r = e / NX, c = e - r * NX;
    Pinv[(size_t)k * 3 * NN + NN + e] = aug[r * 2 * NX + NX + c];
  }
}

__global__ void __launch_bounds__(256)
stair_kernel(const float* __restrict__ S, const float* __restrict__ bmask,
             int N, float* __restrict__ Pinv) {
  const int k = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  S += (size_t)blockIdx.y * N * 3 * NN;
  Pinv += (size_t)blockIdx.y * N * 3 * NN;
  const float* bm = bmask != nullptr ? bmask + (size_t)blockIdx.y * 2 * N : nullptr;
  __shared__ float tl[NN], tr[NN];
  const float* Dk = Pinv + (size_t)k * 3 * NN + NN;
  const float* Sk = S + (size_t)k * 3 * NN;
  for (int e = tid; e < NN; e += nth) {
    const int r = e / NX, c = e - r * NX;
    float al = 0.f, ar = 0.f;
    for (int j = 0; j < NX; ++j) {
      al += Dk[r * NX + j] * Sk[j * NX + c];
      ar += Dk[r * NX + j] * Sk[2 * NN + j * NX + c];
    }
    tl[e] = al;
    tr[e] = ar;
  }
  __syncthreads();
  float* Pk = Pinv + (size_t)k * 3 * NN;
  for (int e = tid; e < NN; e += nth) {
    const int r = e / NX, c = e - r * NX;
    float left = 0.f, right = 0.f;
    if (!first_knot(bm, k)) {
      const float* Dm = Pinv + (size_t)(k - 1) * 3 * NN + NN;
      for (int j = 0; j < NX; ++j) left += tl[r * NX + j] * Dm[j * NX + c];
      left = -left;
    }
    if (!last_knot(bm, N, k)) {
      const float* Dp = Pinv + (size_t)(k + 1) * 3 * NN + NN;
      for (int j = 0; j < NX; ++j) right += tr[r * NX + j] * Dp[j * NX + c];
      right = -right;
    }
    Pk[e] = left;
    Pk[2 * NN + e] = right;
  }
}

int kkt_schur_impl(const float* xu, int xu_stride, int xu_bstride,
                   const float* goal, int goal_stride, int goal_bstride,
                   const float* rho, int rho_bstride, const float* bmask,
                   float dt, const float* model, float gravity, float qd_cost,
                   float r_cost, int N, int batch, int integrator_type,
                   int wrap, int terminal_at_last, float* S, float* Pinv,
                   float* gamma, float* Qinv, float* A, float* B, float* q,
                   float* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N, batch);
  knot_kernel<true><<<grid, 256, 0, st>>>(
      xu, xu_stride, xu_bstride, goal, goal_stride, goal_bstride, nullptr,
      rho, rho_bstride, bmask, dt, model, gravity, qd_cost, r_cost, N,
      integrator_type, wrap, terminal_at_last, Qinv, A, B, q, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  schur_kernel<<<grid, 256, 0, st>>>(xu, xu_stride, xu_bstride, Qinv, q,
                                     scratch, bmask, N, S, Pinv, gamma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stair_kernel<<<grid, 256, 0, st>>>(S, bmask, N, Pinv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// batch instances side by side (K8a; K1 is batch = 1): instance b reads
// xu + b xu_bstride, goal + b goal_bstride, rho[b] and writes the b-th
// (N, ...) slab of every output.
extern "C" int kkt_schur_launch(
    const float* xu, int xu_stride, int xu_bstride, const float* goal,
    int goal_stride, int goal_bstride, const float* rho, float dt,
    const float* model, float gravity, float qd_cost, float r_cost, int N,
    int batch, int integrator_type, int wrap, int terminal_at_last, float* S,
    float* Pinv, float* gamma, float* Qinv, float* A, float* B, float* q,
    float* scratch, void* stream) {
  return kkt_schur_impl(xu, xu_stride, xu_bstride, goal, goal_stride,
                        goal_bstride, rho, 1, nullptr, dt, model, gravity,
                        qd_cost, r_cost, N, batch, integrator_type, wrap,
                        terminal_at_last, S, Pinv, gamma, Qinv, A, B, q,
                        scratch, stream);
}

// K9a: shards side by side, each a window of Lext knots: shard b reads
// rows b Lext .. of xu (rows of NX + NU) and of the goal (rows of
// goal_stride), its flags bmask + 2 Lext b and the one rho, and writes the
// b-th (Lext, ...) slab of every output
extern "C" int kkt_schur_slab_launch(
    const float* xu, const float* goal, int goal_stride, const float* bmask,
    const float* rho, float dt, const float* model, float gravity,
    float qd_cost, float r_cost, int Lext, int n_shard, int integrator_type,
    int terminal_at_last, float* S, float* Pinv, float* gamma, float* Qinv,
    float* A, float* B, float* q, float* scratch, void* stream) {
  return kkt_schur_impl(xu, W, Lext * W, goal, goal_stride,
                        Lext * goal_stride, rho, 0, bmask, dt, model, gravity,
                        qd_cost, r_cost, Lext, n_shard, integrator_type, 0,
                        terminal_at_last, S, Pinv, gamma, Qinv, A, B, q,
                        scratch, stream);
}

extern "C" int kkt_launch(const float* xu, int xu_stride, const float* goal,
                          int goal_stride, const float* xs, float dt,
                          const float* model, float gravity, float qd_cost,
                          int N, int integrator_type, int wrap,
                          int terminal_at_last, float* Q, float* A, float* B,
                          float* q, float* c, void* stream) {
  knot_kernel<false><<<N, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      xu, xu_stride, 0, goal, goal_stride, 0, xs, nullptr, 0, nullptr, dt,
      model, gravity, qd_cost, 0.f, N, integrator_type, wrap,
      terminal_at_last, Q, A, B, q, c);
  return static_cast<int>(cudaGetLastError());
}
