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
// levels are dependent, so the time is the depth of the chain.  Measured on
// the earlier design (a launch per level and per refinement level, a block
// of 256 threads per knot; clock64 stamps): the 14-step Gauss-Jordan took
// ~14,000 of a level's ~18,000 cycles (two block barriers and a division
// with zero dividends, IEEE division's slow path, per step), and the 13
// launch gaps 17 us of 87 at N = 64.
//
// Design: ONE LAUNCH PER SOLVE, factorisation and refinement together,
// laid out by ops/pcr_cuda.py::pcr_plan(N), a fixed function of N: kpc
// knots per CTA, one warp per knot for the whole solve, ceil(N / kpc) CTAs.
// A knot's warp keeps its th, b and the last two levels' L and U in its
// shared memory; it runs the Gauss-Jordan with the augmented matrix in
// registers (lane c < 2 NX holds column c; each step's pivot row and column
// travel by shuffles; common.cuh::div_rn gives IEEE division's bits without
// the slow path) and the 14x14 products as map_entries over the warp, with
// warp syncs only.  The levels and the refinement's levels are separated by
// one barrier each: a cluster barrier where all ceil(N / kpc) CTAs fit in
// one cluster of at most 16 (N <= 64; 16 is a non-portable size, which the
// launch requests), with each knot's A, B and v of the last level in its
// CTA's shared memory (two slots by step parity) and the neighbours' read
// through distributed shared memory; otherwise a grid barrier of a
// cooperative launch (every CTA resident: the plan's occupancy check), with
// the slots in global memory read through L2 (ld.global.cg).  The factors
// the refinement needs (th^{-1}, L, U of every level) stay in a global
// workspace: (3 levels + 1) x 196 floats a knot, 1.4 MB at N = 64 and 11 MB
// at N = 512, which the 50 MB L2 holds.  Every entry is computed in the
// earlier design's order (row_dot, mm_entry, the Gauss-Jordan's update), so
// the outputs are its bits.
#include <cooperative_groups.h>

#include "common.cuh"

using namespace mpc;
namespace cg = cooperative_groups;

namespace {

constexpr int NN = NX * NX;
constexpr int PCR_KPC = 4;                  // knots (warps) per CTA
constexpr int PCR_MAX_CLUSTER = 16;
// a knot's slot: A, B and v of its last level, read by the neighbours
constexpr int SLOT = 2 * NN + NX;
// a warp's shared floats: th, b, L and U of two levels, th^{-1}, the
// neighbours' slots (two), the refinement's residual and three x rows
constexpr int WARP_FLOATS = NN + NX + 4 * NN + NN + 2 * SLOT + NX + 3 * NX;

// bytes of a CTA's dynamic shared memory (see pcr_plan): each warp's
// floats, and the CTA's slots where they are shared (cluster)
__host__ __device__ constexpr int pcr_smem_bytes(int kpc, int cluster) {
  return 4 * kpc * (WARP_FLOATS + cluster * 2 * SLOT);
}

// The global workspace, floats: per level th^{-1} (one level more, the
// final th_f^{-1}), L and U (levels x N x NN each), and the slots of the
// cooperative launch (2 x N x SLOT).
struct Work {
  float *thinv, *L, *U, *slots;
  __host__ __device__ Work(float* w, int N, int levels) {
    const size_t m = (size_t)N * NN;
    thinv = w;
    L = thinv + (levels + 1) * m;
    U = L + levels * m;
    slots = U + levels * m;
  }
};

// out = M x, M (NX, NX) in shared or global memory, one row per lane
__device__ inline float row_dot(const float* M, const float* x, int i) {
  float acc = 0.f;
  for (int j = 0; j < NX; ++j) acc += M[i * NX + j] * x[j];
  return acc;
}

// (M P)[r][c]
__device__ inline float mm_entry(const float* M, const float* P, int r, int c) {
  float acc = 0.f;
  for (int j = 0; j < NX; ++j) acc += M[r * NX + j] * P[j * NX + c];
  return acc;
}

// a neighbour's data: through distributed shared memory (cluster) or L2
template <bool kCluster>
__device__ inline float ld_nb(const float* p) {
  if constexpr (kCluster) return *p;
  else return __ldcg(p);
}

template <bool kCluster>
__device__ inline void level_sync() {
  if constexpr (kCluster) {
    cluster_arrive();
    cluster_wait();
  } else {
    cg::this_grid().sync();
  }
}

struct Upd {
  float t, l, u;
};

struct AB {
  float a, b;
};

// The whole solve.  Warp w of CTA q owns knot k = q PCR_KPC + w (none where
// k >= N; that warp only meets the barriers).  Step g (levels + 1 of the
// factorisation, then levels + 1 per refinement pass) writes its slot
// g & 1 and reads the neighbours' slot (g - 1) & 1, written before the
// barrier that ends step g - 1.
template <bool kCluster>
__global__ void __launch_bounds__(32 * PCR_KPC)
pcr_kernel(const float* __restrict__ S, const float* __restrict__ b0, int N,
           int levels, int refine, float* __restrict__ ws,
           float* __restrict__ x) {
  extern __shared__ __align__(16) float sh[];
  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * PCR_KPC + warp;
  const bool active = k < N;
  Work w(ws, N, levels);
  float* th = sh + warp * WARP_FLOATS;
  float* sb = th + NN;
  float* LU = sb + NX;             // [L, U] of the levels of parity 0, 1
  float* Ti = LU + 4 * NN;
  float* stm = Ti + NN;            // slot of knot k - s
  float* stp = stm + SLOT;         // slot of knot k + s
  float* sr = stp + SLOT;
  float* xs = sr + NX;             // x of knots k - 1, k, k + 1
  float* cslots = sh + PCR_KPC * WARP_FLOATS;   // kCluster: the CTA's slots
  // knot j's slot of parity par: in its CTA's shared memory or global
  auto slot = [&](int j, int par) -> float* {
    if constexpr (kCluster) {
      cg::cluster_group cl = cg::this_cluster();
      float* local = cslots + ((j % PCR_KPC) * 2 + par) * SLOT;
      return cl.map_shared_rank(local, j / PCR_KPC);
    } else {
      return w.slots + ((size_t)par * N + j) * SLOT;
    }
  };
  const size_t kk = (size_t)k * NN;
  const int steps = (levels + 1) * (1 + refine);
  for (int g = 0; g < steps; ++g) {
    const int l = g % (levels + 1), par = g & 1;
    if (active && g <= levels) {
      // ---- factorisation, level l ----
      float* nLU = LU + (l & 1) * 2 * NN;          // this level's L, U
      const float* sLU = LU + ((l + 1) & 1) * 2 * NN;  // level l - 1's
      if (l == 0) {
        const float* Sk = S + kk * 3;
        for (int e = lane; e < NN; e += 32) {
          nLU[e] = k > 0 ? Sk[e] : 0.f;
          nLU[NN + e] = k < N - 1 ? Sk[2 * NN + e] : 0.f;
          th[e] = Sk[NN + e];
        }
        if (lane < NX) sb[lane] = b0[k * NX + lane];
      } else {
        const int s = 1 << (l - 1);
        const bool lo = k - s >= 0, hi = k + s < N;
        const bool lo2 = k - 2 * s >= 0, hi2 = k + 2 * s < N;
        const float* sL = sLU;
        const float* sU = sLU + NN;
        // the neighbours' slots: every load in flight before the stores
        if (lo) {
          const float* src = slot(k - s, par ^ 1);
          map_entries<SLOT, 32>(lane, [&](int e) { return ld_nb<kCluster>(src + e); },
                                [&](int e, float v) { stm[e] = v; });
        }
        if (hi) {
          const float* src = slot(k + s, par ^ 1);
          map_entries<SLOT, 32>(lane, [&](int e) { return ld_nb<kCluster>(src + e); },
                                [&](int e, float v) { stp[e] = v; });
        }
        __syncwarp();
        const float *Am = stm, *Bm = stm + NN, *vm = stm + 2 * NN;
        const float *Ap = stp, *Bp = stp + NN, *vp = stp + 2 * NN;
        map_entries<NN, 32>(
            lane,
            [&](int e) {
              const int r = e / NX, c = e - r * NX;
              float t = th[e];
              if (lo) t -= mm_entry(sL, Bm, r, c);
              if (hi) t -= mm_entry(sU, Ap, r, c);
              return Upd{t, lo2 ? -mm_entry(sL, Am, r, c) : 0.f,
                         hi2 ? -mm_entry(sU, Bp, r, c) : 0.f};
            },
            [&](int e, Upd v) {
              th[e] = v.t;
              nLU[e] = v.l;
              nLU[NN + e] = v.u;
            });
        if (lane < NX) {
          float t = sb[lane];
          if (lo) t -= row_dot(sL, vm, lane);
          if (hi) t -= row_dot(sU, vp, lane);
          sb[lane] = t;
        }
      }
      __syncwarp();
      // Gauss-Jordan of [th | I]: lane c < 2 NX holds column c
      float col[NX];
#pragma unroll
      for (int r = 0; r < NX; ++r)
        col[r] = lane < NX ? th[r * NX + lane] : (r == lane - NX ? 1.f : 0.f);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const float piv = div_rn(col[i], __shfl_sync(full, col[i], i));
        float f[NX];
#pragma unroll
        for (int r = 0; r < NX; ++r) f[r] = __shfl_sync(full, col[r], i);
#pragma unroll
        for (int r = 0; r < NX; ++r) col[r] = r == i ? piv : col[r] - f[r] * piv;
      }
      float* thinv = w.thinv + (size_t)l * N * NN + kk;
      if (lane >= NX && lane < 2 * NX) {
#pragma unroll
        for (int r = 0; r < NX; ++r) {
          Ti[r * NX + lane - NX] = col[r];
          thinv[r * NX + lane - NX] = col[r];
        }
      }
      __syncwarp();
      if (l == levels) {
        if (lane < NX) {
          float acc = 0.f;
          for (int j = 0; j < NX; ++j) acc += Ti[lane * NX + j] * sb[j];
          x[k * NX + lane] = acc;
        }
      } else {
        float* own = slot(k, par);
        const size_t lev = (size_t)l * N * NN + kk;
        map_entries<NN, 32>(
            lane,
            [&](int e) {
              const int r = e / NX, c = e - r * NX;
              float a = 0.f, bb = 0.f;
              for (int j = 0; j < NX; ++j) {
                a += Ti[r * NX + j] * nLU[j * NX + c];
                bb += Ti[r * NX + j] * nLU[NN + j * NX + c];
              }
              return AB{a, bb};
            },
            [&](int e, AB v) {
              own[e] = v.a;
              own[NN + e] = v.b;
              w.L[lev + e] = nLU[e];
              w.U[lev + e] = nLU[NN + e];
            });
        if (lane < NX) {
          float acc = 0.f;
          for (int j = 0; j < NX; ++j) acc += Ti[lane * NX + j] * sb[j];
          own[2 * NN + lane] = acc;
        }
      }
    } else if (active) {
      // ---- refinement, level l: b is the pass's running right-hand side
      const int i = lane;
      if (l == 0) {
        // r = b0 - S x, rows (centre + left) + right as ops/btd.py sums them
        for (int e = lane; e < 3 * NX; e += 32) {
          const int kn = k - 1 + e / NX;
          xs[e] = kn >= 0 && kn < N ? __ldcg(x + kn * NX + e % NX) : 0.f;
        }
        __syncwarp();
        if (i < NX) {
          const float* Sk = S + kk * 3;
          float c = 0.f, lf = 0.f, rt = 0.f;
          for (int j = 0; j < NX; ++j) c += Sk[NN + i * NX + j] * xs[NX + j];
          if (k > 0)
            for (int j = 0; j < NX; ++j) lf += Sk[i * NX + j] * xs[j];
          if (k < N - 1)
            for (int j = 0; j < NX; ++j) rt += Sk[2 * NN + i * NX + j] * xs[2 * NX + j];
          sr[i] = b0[k * NX + i] - ((c + lf) + rt);
        }
      } else {
        const int s = 1 << (l - 1);
        const size_t lev = (size_t)(l - 1) * N * NN + kk;
        if (lane < NX && k - s >= 0)
          stm[2 * NN + lane] = ld_nb<kCluster>(slot(k - s, par ^ 1) + 2 * NN + lane);
        if (lane < NX && k + s < N)
          stp[2 * NN + lane] = ld_nb<kCluster>(slot(k + s, par ^ 1) + 2 * NN + lane);
        __syncwarp();
        if (i < NX) {
          float t = sb[i];
          if (k - s >= 0) t -= row_dot(w.L + lev, stm + 2 * NN, i);
          if (k + s < N) t -= row_dot(w.U + lev, stp + 2 * NN, i);
          sr[i] = t;
        }
      }
      __syncwarp();
      if (i < NX) {
        const float acc = row_dot(w.thinv + (size_t)l * N * NN + kk, sr, i);
        if (l == levels) {
          x[k * NX + i] = __ldcg(x + k * NX + i) + acc;
        } else {
          slot(k, par)[2 * NN + i] = acc;
          sb[i] = sr[i];
        }
      }
    }
    // the last step's slot reads done before any CTA leaves (cluster)
    if (g < steps - 1 || kCluster) level_sync<kCluster>();
  }
}

}  // namespace

// The plan's launch (ops/pcr_cuda.py::pcr_plan): ctas CTAs of 32 PCR_KPC
// threads and smem bytes of dynamic shared memory (at least
// pcr_smem_bytes(PCR_KPC, cluster)); one cluster of all of them (cluster)
// or a cooperative launch.  ws holds N ((3 levels + 1) NX^2 + 2 SLOT)
// floats (Work above).  A shape the plan does not describe is refused
// (cudaErrorInvalidValue); a launch the card cannot hold fails with its
// error.
extern "C" int pcr_launch(const float* S, const float* b, int N, int levels,
                          int refine, int ctas, int cluster, int smem,
                          float* ws, float* x, void* stream) {
  if (N < 2 || refine < 0 || ctas != (N + PCR_KPC - 1) / PCR_KPC ||
      (cluster && ctas > PCR_MAX_CLUSTER) ||
      smem < pcr_smem_bytes(PCR_KPC, cluster ? 1 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cluster) {
    const auto kernel = pcr_kernel<true>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess && ctas > 8)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cfg.gridDim = dim3(ctas, 1, 1);
    cfg.blockDim = dim3(32 * PCR_KPC, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, S, b, N, levels, refine, ws, x);
  } else {
    const auto kernel = pcr_kernel<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&S, &b, &N, &levels, &refine, &ws, &x};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                      dim3(ctas), dim3(32 * PCR_KPC), args,
                                      static_cast<size_t>(smem), st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// how many CTAs of the cooperative launch one SM holds at smem bytes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out
extern "C" int pcr_coop_occupancy(int smem, int* out) {
  const auto kernel = pcr_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                        32 * PCR_KPC, smem);
  return static_cast<int>(err);
}
