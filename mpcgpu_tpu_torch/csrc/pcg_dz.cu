// K2: warm-started stair-preconditioned PCG on the BTD Schur system, with
// the dz (primal step) recovery as its epilogue; K2' the same kernel with
// the epilogue compiled out; K6 the epilogue as its own launch.
//
// Replaces the TPU kernels mpcgpu_tpu/ops/pcg_pallas.py::
// pcg_dz_solve_pallas_lanes (K2: _make_pcg_dz_kernel = _make_pcg_kernel +
// kkt_pallas.py::dz_from_lane_values), pcg_solve_pallas_lanes and
// pcg_solve_pallas (K2': _make_pcg_kernel) and mpcgpu_tpu/solver/
// kkt_pallas.py::compute_dz_pallas (K6: _make_dz_kernel).  Iteration
// semantics are the TPU kernel's, exactly: r0 = gamma - S lam0 and the exit
// test runs once on (r0, eta0) before any step; each step computes alpha =
// eta / (p . Sp), then z = Pinv r, then eta'; `done` is tested after the
// update; after the exit or the cap no step runs, and `iters` counts the
// steps that ran.  The exit is |eta| < tol ("eta") or ||r||^2 < tol^2
// ("rnorm").  K2 and K2' are one template (kDz), so their iterations are the
// same code and their lam the same bits.
//
// What bounds K2 on an H100: one solve is up to a few hundred dependent
// iterations, each a BTD matvec with S and one with Pinv (2 x 3 x 14 x 14 x N
// floats: 301 KB at N = 64, 2.4 MB at N = 512) and two reductions over N x 14
// values.  S and Pinv exceed one block's 227 KB of shared memory at large N,
// so this first design runs the whole solve in ONE block: lam, r, p, z and Sp
// live in shared memory (5 x 14 x N floats: 18 KB at N = 64, 143 KB at
// N = 512, hence the dynamic shared-memory attribute), and S and Pinv are
// streamed from L2 every iteration (they stay resident in the 50 MB L2).  The
// cost per iteration is then L2 bandwidth of one SM plus the block-wide syncs
// of the two fixed-order reductions (deterministic for a given block size).
// A one-block-per-block-row cooperative design (GBD-PCG) or a thread-block
// cluster holding S and Pinv in distributed shared memory is later work.
//
// The edge blocks S[0,0] and S[N-1,2] are skipped by explicit bounds, not
// relied on to be zero.  The dz recovery computes, with lam_{N} = 0 and no
// du at the last knot,
//   dx_k = Qinv_k (q_k - lam_k + A_k^T lam_{k+1}),
//   du_k = (r_cost u_k + B_k^T lam_{k+1}) / (r_cost + rho).
// K6 is latency-bound: it reads Qinv, A, B (~3 x 14 x 14 x N floats) once and
// does ~1.5 KFLOP per knot; one block per knot, one thread per output.  Its
// per-output arithmetic is K2's epilogue (the same device functions).
//
// K8b and K8c replace mpcgpu_tpu/parallel/batched_fused.py::
// pcg_solve_batched_lanes (_make_pcg_kernel_packed: instances packed on
// lanes with segmented reductions) and compute_dz_batched.  K8b is K2' with
// one block per instance (blockIdx.x): every block runs its own CG scalars
// and stops at its own exit, which is what the packed TPU kernel emulates
// with masks, so each instance's lam, iters and exit flag equal those of
// K2' bit for bit.  K8c is K6 over a (knot, instance) grid with a
// per-instance rho.
//
// K9b replaces mpcgpu_tpu/solver/kkt_pallas.py::compute_dz_pallas_slab
// (_make_dz_kernel with boundary_masks=True), the dz recovery of one knot
// shard's slab in the knot-sharded SQP.  It is K6 over a (knot, shard) grid
// where lam_{k+1} comes from a second input, the shard's lam shifted by one
// knot with the right neighbour's first row appended (the halo the caller
// exchanged), and "k is the last knot" from a runtime flag per knot.  The
// blocks Qinv, A, B, q are read in place from K9a's halo-extended slabs (a
// knot stride between shards).  Its dz equals K6's on the same rows bit for
// bit (the same device functions); latency-bound as K6.
#include "common.cuh"

using namespace mpc;

namespace {

constexpr int NN = NX * NX;
constexpr int THREADS = 1024;

// row (k, i) of the BTD product M x, M (N, 3, NX, NX); (center + left) + right
__device__ inline float btd_row(const float* __restrict__ M, const float* x,
                                int row, int N) {
  const int k = row / NX, i = row - k * NX;
  const float* Mk = M + (size_t)k * 3 * NN;
  float c = 0.f, l = 0.f, r = 0.f;
  for (int j = 0; j < NX; ++j) c += Mk[NN + i * NX + j] * x[k * NX + j];
  if (k > 0)
    for (int j = 0; j < NX; ++j) l += Mk[i * NX + j] * x[(k - 1) * NX + j];
  if (k < N - 1)
    for (int j = 0; j < NX; ++j) r += Mk[2 * NN + i * NX + j] * x[(k + 1) * NX + j];
  return (c + l) + r;
}

// Right-hand side of dx at row (k, c): (q_k - lam_k)_c + (A_k^T lam_{k+1})_c,
// lam_n the row lam_{k+1} (not read at the last knot, has_next false).
__device__ inline float dz_rhs(const float* __restrict__ A,
                               const float* __restrict__ q, const float* lam,
                               const float* lam_n, bool has_next, int k, int c) {
  float at = 0.f;
  if (has_next) {
    const float* Ak = A + (size_t)k * NN;
    for (int j = 0; j < NX; ++j) at += Ak[j * NX + c] * lam_n[j];
  }
  return (q[k * NX + c] - lam[k * NX + c]) + at;
}

// dx_k[c] = (Qinv_k rhs_k)_c, rhs_k the knot's NX right-hand sides.
__device__ inline float dz_dx(const float* __restrict__ Qinv, const float* rhs,
                              int k, int c) {
  const float* Qk = Qinv + (size_t)k * NN;
  float acc = 0.f;
  for (int j = 0; j < NX; ++j) acc += Qk[c * NX + j] * rhs[j];
  return acc;
}

// du_k[c] = s_r (r_cost u_k[c] + (B_k^T lam_{k+1})_c), 0 at the last knot.
__device__ inline float dz_du(const float* __restrict__ B, const float* lam_n,
                              bool has_next, const float* __restrict__ u,
                              int u_stride, float r_cost, float s_r, int k,
                              int c) {
  if (!has_next) return 0.f;
  const float* Bk = B + (size_t)k * NX * NU;
  float bt = 0.f;
  for (int j = 0; j < NX; ++j) bt += Bk[j * NU + c] * lam_n[j];
  return s_r * (r_cost * u[k * u_stride + c] + bt);
}

// kBatch: blockIdx.x is an instance (K8b); without it the kernel reads its
// pointers as given, so K2 and K2' keep them in the parameter bank
template <bool kDz, bool kBatch>
__global__ void __launch_bounds__(THREADS)
pcg_dz_kernel(const float* __restrict__ S, const float* __restrict__ Pinv,
              const float* __restrict__ gamma, const float* __restrict__ lam0,
              const float* __restrict__ Qinv, const float* __restrict__ A,
              const float* __restrict__ B, const float* __restrict__ q,
              const float* __restrict__ u, int u_stride,
              const float* __restrict__ rho_p, float r_cost, int max_iter,
              const float* __restrict__ tol_p, int rnorm, int N,
              float* __restrict__ lam_o, float* __restrict__ dz,
              int* __restrict__ iters_o, int* __restrict__ conv_o) {
  extern __shared__ float sh[];
  __shared__ float red[33];
  const int n = N * NX, tid = threadIdx.x, nth = blockDim.x;
  // instance blockIdx.x (K8b): its own system, its own CG scalars and exit
  const int b = kBatch ? blockIdx.x : 0;
  if constexpr (kBatch) {
    S += (size_t)b * N * 3 * NN;
    Pinv += (size_t)b * N * 3 * NN;
    gamma += (size_t)b * n;
    lam0 += (size_t)b * n;
    lam_o += (size_t)b * n;
  }
  float* lam = sh;
  float* r = lam + n;
  float* p = r + n;
  float* z = p + n;
  float* Sp = z + n;
  const float tol = *tol_p;

  for (int i = tid; i < n; i += nth) lam[i] = lam0[i];
  __syncthreads();
  for (int i = tid; i < n; i += nth) r[i] = gamma[i] - btd_row(S, lam, i, N);
  __syncthreads();
  float rz = 0.f, rr = 0.f;
  for (int i = tid; i < n; i += nth) {
    const float zi = btd_row(Pinv, r, i, N);
    z[i] = zi;
    p[i] = zi;
    rz += r[i] * zi;
    rr += r[i] * r[i];
  }
  float eta = block_sum(rz, red);
  if (rnorm) rr = block_sum(rr, red);
  bool done = rnorm ? rr < tol * tol : fabsf(eta) < tol;
  int it = 0;
  while (it < max_iter && !done) {
    float pSp = 0.f;
    for (int i = tid; i < n; i += nth) {
      const float s = btd_row(S, p, i, N);
      Sp[i] = s;
      pSp += p[i] * s;
    }
    const float alpha = eta / block_sum(pSp, red);
    for (int i = tid; i < n; i += nth) {
      lam[i] += alpha * p[i];
      r[i] -= alpha * Sp[i];
    }
    __syncthreads();
    rz = 0.f;
    rr = 0.f;
    for (int i = tid; i < n; i += nth) {
      const float zi = btd_row(Pinv, r, i, N);
      z[i] = zi;
      rz += r[i] * zi;
      rr += r[i] * r[i];
    }
    const float eta_new = block_sum(rz, red);
    if (rnorm) rr = block_sum(rr, red);
    done = rnorm ? rr < tol * tol : fabsf(eta_new) < tol;
    const float beta = eta_new / eta;
    for (int i = tid; i < n; i += nth) p[i] = z[i] + beta * p[i];
    eta = eta_new;
    ++it;
    __syncthreads();
  }

  if constexpr (kDz) {
    const float s_r = 1.f / (r_cost + *rho_p);
    for (int i = tid; i < n; i += nth) {
      const int k = i / NX, c = i - k * NX;
      z[i] = dz_rhs(A, q, lam, lam + (k + 1) * NX, k < N - 1, k, c);
      lam_o[i] = lam[i];
    }
    __syncthreads();
    for (int i = tid; i < n; i += nth) {
      const int k = i / NX, c = i - k * NX;
      dz[k * W + c] = dz_dx(Qinv, z + k * NX, k, c);
    }
    for (int i = tid; i < N * NU; i += nth) {
      const int k = i / NU, c = i - k * NU;
      dz[k * W + NX + c] = dz_du(B, lam + (k + 1) * NX, k < N - 1, u, u_stride,
                                 r_cost, s_r, k, c);
    }
  } else {
    for (int i = tid; i < n; i += nth) lam_o[i] = lam[i];
  }
  if (tid == 0) {
    iters_o[b] = it;
    conv_o[b] = done ? 1 : 0;
  }
}

// lam_next, lastm: K9b's lam_{k+1} rows and last-knot flags (N per shard),
// or nullptr (K6, K8c: the next row of lam, and k = N - 1).  The blocks of
// instance b start sys_nstride knots after those of instance b - 1.
__global__ void __launch_bounds__(32)
dz_kernel(const float* __restrict__ lam, const float* __restrict__ lam_next,
          const float* __restrict__ lastm, const float* __restrict__ Qinv,
          const float* __restrict__ A, const float* __restrict__ B,
          const float* __restrict__ q, int sys_nstride,
          const float* __restrict__ u, int u_stride, int u_bstride,
          const float* __restrict__ rho_p, int rho_bstride, float r_cost,
          int N, float* __restrict__ dz) {
  __shared__ float rhs[NX];
  const int k = blockIdx.x, tid = threadIdx.x;
  // instance or shard blockIdx.y (K8c, K9b; K6 is one instance)
  const int b = blockIdx.y;
  lam += (size_t)b * N * NX;
  Qinv += (size_t)b * sys_nstride * NN;
  A += (size_t)b * sys_nstride * NN;
  B += (size_t)b * sys_nstride * NX * NU;
  q += (size_t)b * sys_nstride * NX;
  u += (size_t)b * u_bstride;
  rho_p += (size_t)b * rho_bstride;
  dz += (size_t)b * N * W;
  const float* lam_n = lam_next != nullptr
      ? lam_next + ((size_t)b * N + k) * NX : lam + (k + 1) * NX;
  const bool has_next = lastm != nullptr ? lastm[(size_t)b * N + k] == 0.f
                                         : k < N - 1;
  if (tid < NX) rhs[tid] = dz_rhs(A, q, lam, lam_n, has_next, k, tid);
  __syncthreads();
  if (tid < NX) {
    dz[k * W + tid] = dz_dx(Qinv, rhs, k, tid);
  } else if (tid < W) {
    const float s_r = 1.f / (r_cost + *rho_p);
    dz[k * W + tid] = dz_du(B, lam_n, has_next, u, u_stride, r_cost, s_r, k,
                            tid - NX);
  }
}

template <bool kDz, bool kBatch>
int pcg_launch_impl(const float* S, const float* Pinv, const float* gamma,
                    const float* lam0, const float* Qinv, const float* A,
                    const float* B, const float* q, const float* u,
                    int u_stride, const float* rho, float r_cost, int max_iter,
                    const float* tol, int rnorm, int N, int batch, float* lam,
                    float* dz, int* iters, int* conv, void* stream) {
  const size_t smem = (size_t)5 * N * NX * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pcg_dz_kernel<kDz, kBatch>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pcg_dz_kernel<kDz, kBatch><<<batch, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      S, Pinv, gamma, lam0, Qinv, A, B, q, u, u_stride, rho, r_cost, max_iter,
      tol, rnorm, N, lam, dz, iters, conv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pcg_dz_launch(const float* S, const float* Pinv,
                             const float* gamma, const float* lam0,
                             const float* Qinv, const float* A, const float* B,
                             const float* q, const float* u, int u_stride,
                             const float* rho, float r_cost, int max_iter,
                             const float* tol, int rnorm, int N, float* lam,
                             float* dz, int* iters, int* conv, void* stream) {
  return pcg_launch_impl<true, false>(S, Pinv, gamma, lam0, Qinv, A, B, q, u,
                                      u_stride, rho, r_cost, max_iter, tol,
                                      rnorm, N, 1, lam, dz, iters, conv,
                                      stream);
}

// batch instances, one block each (K8b; K2' is batch = 1): instance b
// solves the b-th (N, ...) slab of S, Pinv, gamma, lam0 into lam, iters[b],
// conv[b]
extern "C" int pcg_launch(const float* S, const float* Pinv,
                          const float* gamma, const float* lam0, int max_iter,
                          const float* tol, int rnorm, int N, int batch,
                          float* lam, int* iters, int* conv, void* stream) {
  const auto launch = batch > 1 ? pcg_launch_impl<false, true>
                                 : pcg_launch_impl<false, false>;
  return launch(S, Pinv, gamma, lam0, nullptr, nullptr, nullptr, nullptr,
                nullptr, 0, nullptr, 0.f, max_iter, tol, rnorm, N, batch, lam,
                nullptr, iters, conv, stream);
}

// batch instances side by side (K8c; K6 is batch = 1): instance b reads
// u + b u_bstride, rho[b] and the b-th (N, ...) slab of the other inputs
extern "C" int dz_launch(const float* lam, const float* Qinv, const float* A,
                         const float* B, const float* q, const float* u,
                         int u_stride, int u_bstride, const float* rho,
                         float r_cost, int N, int batch, float* dz,
                         void* stream) {
  dz_kernel<<<dim3(N, batch), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      lam, nullptr, nullptr, Qinv, A, B, q, N, u, u_stride, u_bstride, rho, 1,
      r_cost, N, dz);
  return static_cast<int>(cudaGetLastError());
}

// K9b: shards side by side: shard b reads the b-th (L, ...) slab of lam,
// lam_next and lastm, the blocks from knot b sys_nstride on, u + b u_bstride
// and the one rho, and writes the b-th (L, NX + NU) slab of dz
extern "C" int dz_slab_launch(const float* lam, const float* lam_next,
                              const float* lastm, const float* Qinv,
                              const float* A, const float* B, const float* q,
                              int sys_nstride, const float* u, int u_stride,
                              int u_bstride, const float* rho, float r_cost,
                              int L, int n_shard, float* dz, void* stream) {
  dz_kernel<<<dim3(L, n_shard), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      lam, lam_next, lastm, Qinv, A, B, q, sys_nstride, u, u_stride,
      u_bstride, rho, 0, r_cost, L, dz);
  return static_cast<int>(cudaGetLastError());
}
