// K7: exact solve of the SPD block-tridiagonal system S x = b by parallel
// cyclic reduction, with iterative refinement through the stored factors.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pcr_pallas.py::
// pcr_solve_pallas_lanes (_make_pcr_kernel; pcr_solve_pallas is its
// standard-layout entry).  The algorithm and its order are those of
// mpcgpu_tpu_torch/ops/pcr.py (pcr_factor, pcr_sweep, pcr_solve_refined, the
// plain version): ceil(log2 N) levels; at level l (s = 2^l) every knot k
// takes th_k^{-1} by Gauss-Jordan without pivoting (th stays SPD: each level
// is a Schur complement of an SPD matrix), A = th^{-1} L, B = th^{-1} U,
// v = th^{-1} b, and then the neighbour update
//   L' = -L_k A_{k-s} (0 where k-2s < 0),  U' = -U_k B_{k+s} (0 where
//   k+2s >= N),  th' = th_k - L_k B_{k-s} - U_k A_{k+s},
//   b' = b_k - L_k v_{k-s} - U_k v_{k+s},
// with the terms of neighbours outside 0..N-1 left out by explicit bounds
// (the TPU kernel rolls lanes and relies on zeroed L/U rows instead).  Then
// x = th_f^{-1} b.  Each refinement pass forms r = b0 - S x and sweeps r
// through the stored per-level factors (th^{-1}, L, U): only mat-vecs.
//
// What bounds it on an H100: latency.  The work is ~30 KFLOP per knot and
// level (one 14x14 Gauss-Jordan, six 14x14 products, mat-vecs) and the
// levels are dependent, so the time is the depth of the chain: per level one
// Gauss-Jordan (14 steps, two block syncs each) and the products, plus the
// launch gaps between levels.  Design: one block per knot, levels in stream
// order as separate launches (a level needs its neighbours' A, B, v, a
// grid-wide dependency).  The update of level l and the factorization of
// level l+1 need only knot k's own rows, so they share a launch: a solve is
// levels + 1 launches and each refinement pass levels + 1 more.  The factors
// of every level stay in a global workspace (levels x 5 x 196 x N floats:
// 1.5 MB at N = 64, 18 MB at N = 512), which the 50 MB L2 holds.
#include "common.cuh"

using namespace mpc;

namespace {

constexpr int NN = NX * NX;
constexpr int THREADS = 256;

// The workspace, floats: per level thinv, L, U, A, B (levels x N x NN each;
// thinv has one more level, the final th_f^{-1}) and v (levels x N x NX);
// th (N x NN) and b (N x NX), the current coefficients of each knot.
struct Work {
  float *thinv, *L, *U, *A, *B, *v, *th, *b;
  __host__ __device__ Work(float* w, int N, int levels) {
    const size_t m = (size_t)N * NN;
    thinv = w;
    L = thinv + (levels + 1) * m;
    U = L + levels * m;
    A = U + levels * m;
    B = A + levels * m;
    v = B + levels * m;
    th = v + (size_t)levels * N * NX;
    b = th + m;
  }
};

// out = M x, M (NX, NX) in shared or global memory, one row per thread
__device__ inline float row_dot(const float* M, const float* x, int i) {
  float acc = 0.f;
  for (int j = 0; j < NX; ++j) acc += M[i * NX + j] * x[j];
  return acc;
}

// (M P)[r][c] over the block's threads
__device__ inline float mm_entry(const float* M, const float* P, int r, int c) {
  float acc = 0.f;
  for (int j = 0; j < NX; ++j) acc += M[r * NX + j] * P[j * NX + c];
  return acc;
}

// Level l of the solve, knot k = blockIdx.x.  l = 0 loads L, th, U from S
// and b from b0; l >= 1 applies the neighbour update of level l-1.  Then
// l < levels factors level l (th^{-1}, A, B, v), l == levels writes
// x = th_f^{-1} b.
__global__ void __launch_bounds__(THREADS)
pcr_level_kernel(const float* __restrict__ S, const float* __restrict__ b0,
                 int N, int levels, int l, float* __restrict__ ws,
                 float* __restrict__ x) {
  const int k = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  __shared__ float sL[NN], sU[NN], nL[NN], nU[NN];
  __shared__ float Am[NN], Bm[NN], Ap[NN], Bp[NN];
  __shared__ float aug[NX * 2 * NX], piv[2 * NX], fcol[NX];
  __shared__ float sb[NX], vm[NX], vp[NX];
  Work w(ws, N, levels);
  const size_t kk = (size_t)k * NN;
  if (l == 0) {
    const float* Sk = S + kk * 3;
    for (int e = tid; e < NN; e += nth) {
      const int r = e / NX, c = e - r * NX;
      nL[e] = k > 0 ? Sk[e] : 0.f;
      nU[e] = k < N - 1 ? Sk[2 * NN + e] : 0.f;
      aug[r * 2 * NX + c] = Sk[NN + e];
      w.th[kk + e] = Sk[NN + e];
    }
    if (tid < NX) sb[tid] = b0[k * NX + tid];
  } else {
    const int s = 1 << (l - 1);
    const bool lo = k - s >= 0, hi = k + s < N;
    const size_t lev = (size_t)(l - 1) * N * NN;
    for (int e = tid; e < NN; e += nth) {
      sL[e] = w.L[lev + kk + e];
      sU[e] = w.U[lev + kk + e];
      if (lo) {
        Am[e] = w.A[lev + kk - (size_t)s * NN + e];
        Bm[e] = w.B[lev + kk - (size_t)s * NN + e];
      }
      if (hi) {
        Ap[e] = w.A[lev + kk + (size_t)s * NN + e];
        Bp[e] = w.B[lev + kk + (size_t)s * NN + e];
      }
    }
    if (tid < NX) {
      const size_t lv = (size_t)(l - 1) * N * NX;
      sb[tid] = w.b[k * NX + tid];
      if (lo) vm[tid] = w.v[lv + (k - s) * NX + tid];
      if (hi) vp[tid] = w.v[lv + (k + s) * NX + tid];
    }
    __syncthreads();
    const bool lo2 = k - 2 * s >= 0, hi2 = k + 2 * s < N;
    for (int e = tid; e < NN; e += nth) {
      const int r = e / NX, c = e - r * NX;
      float t = w.th[kk + e];
      if (lo) t -= mm_entry(sL, Bm, r, c);
      if (hi) t -= mm_entry(sU, Ap, r, c);
      aug[r * 2 * NX + c] = t;
      w.th[kk + e] = t;
      nL[e] = lo2 ? -mm_entry(sL, Am, r, c) : 0.f;
      nU[e] = hi2 ? -mm_entry(sU, Bp, r, c) : 0.f;
    }
    __syncthreads();
    if (tid < NX) {
      float t = sb[tid];
      if (lo) t -= row_dot(sL, vm, tid);
      if (hi) t -= row_dot(sU, vp, tid);
      sb[tid] = t;
    }
  }
  for (int e = tid; e < NN; e += nth) {
    const int r = e / NX, c = e - r * NX;
    aug[r * 2 * NX + NX + c] = r == c ? 1.f : 0.f;
  }
  gj_block(aug, NX, 2 * NX, piv, fcol);     // syncs before and after
  float* thinv = w.thinv + (size_t)l * N * NN + kk;
  for (int e = tid; e < NN; e += nth) {
    const int r = e / NX, c = e - r * NX;
    thinv[e] = aug[r * 2 * NX + NX + c];
  }
  // th^{-1} is read from aug's right half: row r, column c at r * 2NX + NX + c
  const float* Ti = aug + NX;
  if (l == levels) {
    if (tid < NX) {
      float acc = 0.f;
      for (int j = 0; j < NX; ++j) acc += Ti[tid * 2 * NX + j] * sb[j];
      x[k * NX + tid] = acc;
    }
    return;
  }
  const size_t lev = (size_t)l * N * NN;
  for (int e = tid; e < NN; e += nth) {
    const int r = e / NX, c = e - r * NX;
    float a = 0.f, bb = 0.f;
    for (int j = 0; j < NX; ++j) {
      a += Ti[r * 2 * NX + j] * nL[j * NX + c];
      bb += Ti[r * 2 * NX + j] * nU[j * NX + c];
    }
    w.A[lev + kk + e] = a;
    w.B[lev + kk + e] = bb;
    w.L[lev + kk + e] = nL[e];
    w.U[lev + kk + e] = nU[e];
  }
  if (tid < NX) {
    float acc = 0.f;
    for (int j = 0; j < NX; ++j) acc += Ti[tid * 2 * NX + j] * sb[j];
    w.v[(size_t)l * N * NX + k * NX + tid] = acc;
    w.b[k * NX + tid] = sb[tid];
  }
}

// Level l of a refinement pass, knot k = blockIdx.x, one thread per row of
// the knot.  l = 0: r = b0 - S x (rows (center + left) + right, as
// ops/btd.py::btd_matvec sums them); l >= 1: r -= L v_{k-s} + U v_{k+s} with
// level l-1's stored L, U and v.  Then v = th^{-1} r (l < levels) or
// x += th_f^{-1} r (l == levels).
__global__ void __launch_bounds__(32)
pcr_refine_kernel(const float* __restrict__ S, const float* __restrict__ b0,
                  int N, int levels, int l, float* __restrict__ ws,
                  float* __restrict__ x) {
  const int k = blockIdx.x, i = threadIdx.x;
  __shared__ float sr[NX];
  Work w(ws, N, levels);
  const size_t kk = (size_t)k * NN;
  if (i < NX) {
    float t;
    if (l == 0) {
      const float* Sk = S + kk * 3;
      float c = 0.f, lf = 0.f, rt = 0.f;
      for (int j = 0; j < NX; ++j) c += Sk[NN + i * NX + j] * x[k * NX + j];
      if (k > 0)
        for (int j = 0; j < NX; ++j) lf += Sk[i * NX + j] * x[(k - 1) * NX + j];
      if (k < N - 1)
        for (int j = 0; j < NX; ++j)
          rt += Sk[2 * NN + i * NX + j] * x[(k + 1) * NX + j];
      t = b0[k * NX + i] - ((c + lf) + rt);
    } else {
      const int s = 1 << (l - 1);
      const size_t lev = (size_t)(l - 1) * N * NN;
      const size_t lv = (size_t)(l - 1) * N * NX;
      t = w.b[k * NX + i];
      if (k - s >= 0) t -= row_dot(w.L + lev + kk, w.v + lv + (k - s) * NX, i);
      if (k + s < N) t -= row_dot(w.U + lev + kk, w.v + lv + (k + s) * NX, i);
    }
    sr[i] = t;
  }
  __syncthreads();
  if (i < NX) {
    const float acc = row_dot(w.thinv + (size_t)l * N * NN + kk, sr, i);
    if (l == levels) {
      x[k * NX + i] += acc;
    } else {
      w.v[(size_t)l * N * NX + k * NX + i] = acc;
      w.b[k * NX + i] = sr[i];
    }
  }
}

}  // namespace

// ws holds N ((5 levels + 2) NX^2 + (levels + 1) NX) floats (Work above).
extern "C" int pcr_launch(const float* S, const float* b, int N, int levels,
                          int refine, float* ws, float* x, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int l = 0; l <= levels; ++l) {
    pcr_level_kernel<<<N, THREADS, 0, st>>>(S, b, N, levels, l, ws, x);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int p = 0; p < refine; ++p) {
    for (int l = 0; l <= levels; ++l) {
      pcr_refine_kernel<<<N, 32, 0, st>>>(S, b, N, levels, l, ws, x);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
