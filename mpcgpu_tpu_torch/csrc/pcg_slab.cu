// K10a: one pipelined (Chronopoulos-Gear) CG step on every knot shard's slab
// of the block-tridiagonal Schur system, the per-shard compute of the
// knot-sharded PCG.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pcg_pallas.py::pcg_slab_step_pallas
// (_pcg_slab_step_kernel), which mpcgpu_tpu/parallel/pcg_sharded.py::
// _pcg_local_pipelined_slab calls once per iteration.  Per shard, with the
// CG scalars of the step (alpha, beta):
//   p = u + beta p;  s = w + beta s;  x += alpha p;  r -= alpha s;
//   u = Pinv r;  w = S u;  partial dots r.u, w.u, r.r over the shard's rows.
// u needs the neighbours' r rows next to the slab and w the rows u_{-1} and
// u_L, which need two r rows on each side and the neighbours' boundary Pinv
// rows (PinvL, PinvR: exchanged once per solve).  The neighbours' rows
// arrive as packets of their (r, w, s) boundary rows BEFORE the step
// (flp: the left neighbour's last two, frp: the right neighbour's first two),
// from which the step's own arithmetic rebuilds their r rows after it:
// r' = r - alpha (w + beta s).  At the ends of the horizon the ring brings
// the far shard's rows, which meet the structurally zero corner blocks
// S[0, 0] = Pinv[0, 0] = 0 and S[N-1, 2] = Pinv[N-1, 2] = 0.
//
// Where the TPU version builds the injected halo rows and u_{-1}, u_L in XLA
// and takes alpha and beta as arguments, this kernel does all of it from the
// packets and from the previous step's cross-shard sums of the dots (tot,
// the mesh's psum, which stays outside: it is the collective): the exit
// test (|eta| < tol, or ||r||^2 < tol^2 for "rnorm"), the iteration cap,
// beta = eta / eta_prev and alpha = eta / (d - beta eta / alpha_prev) (at
// the first step alpha = eta / d), so one SQP iteration's capped loop runs
// on the device with no read-back: a shard whose exit fired returns at once
// and leaves its state, dots and packets as they were.  It also writes the
// packets the shard sends next (pkt: its last two and first two rows of r,
// w, s).  The init call (init = 1) runs the step with alpha = beta = 0,
// which gives u = Pinv r0 and w = S u0, and touches no scalar.
//
// What bounds it on an H100: latency.  A step reads the shard's S and Pinv
// once (2 x 3 x NX^2 x L floats, 301 KB at L = 64 and NX = 14) and does 2 x
// 3 x NX^2 x 2 FLOP per knot, two dependent banded products and three dots.
//
// The design: ONE THREAD-BLOCK CLUSTER PER SHARD (grid (C, n_shard), the
// cluster along x), laid out by ops/pcg_slab_cuda.py::slab_cluster_plan(L),
// a fixed function of L: C CTAs (a power of two <= 16; 16 is a non-portable
// cluster size, which the launch requests) of kc = ceil(L / C) knots (only
// the trailing CTAs hold fewer, or none), one thread per own row.  The exit
// test is the kernel's first work: every CTA of a shard reads the same tot
// and iters and takes the same decision, so an exited cluster returns before
// any set-up.  Then warp 0 starts the bulk copies (TMA, completing on an
// mbarrier) of the CTA's own knots' Pinv and S blocks into shared memory,
// each knot's KB floats contiguous at a stride of SLAB_KNOT_STRIDE floats,
// so that the rows a half-warp reads as float2 fall in distinct banks; the
// copies run under the axpy phase.  Each row's band product loads the band's
// row and the vector's row first, then runs the fma chain in the parent's
// order, (centre + left) + right: x, r, p, s, u, w and the packets are the
// parent's bits.  The neighbours' rows within the shard: after the axpy,
// the threads of the edge knots push their r rows into the neighbours' halo
// rows with st.async, completing on the neighbour's mbarrier; after the
// Pinv product, their u rows likewise (a second mbarrier): no cluster
// barrier between the two products.  The shard's outer edges take the
// cross-shard rows from flp, frp, PinvL and PinvR as before.  The dots: warp
// sums, the CTA's in warp order; each CTA pushes its three sums into rank
// 0's shared memory by st.async, completing on a fourth mbarrier, and rank
// 0 adds them in rank order and writes dots, scal and iters.  One cluster
// barrier, which rank 0 joins once every sum is in, keeps the other CTAs
// resident until their pushes have landed.  Every CTA reads scal and iters
// at entry, before its push, so rank 0's writes follow every read.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

using namespace mpc;
namespace cg = cooperative_groups;

namespace {

constexpr int NN = NX * NX;
constexpr int KB = 3 * NN;   // one knot's three blocks, floats

// K10a's cluster plan limits (ops/pcg_slab_cuda.py): the largest cluster,
// the most threads of a CTA (one per own row), and the stride of a knot's
// blocks in a CTA's shared memory, floats: the least stride >= KB that is
// congruent to NN mod 32, so that thread t of a CTA reads row t at word
// (NX / 2) t mod 16 of the 8-byte banks (612 = 19 x 32 + 4 at NX = 14: word
// 7 t mod 16; a multiple of 4, as NN is, so each knot is 16-byte aligned)
constexpr int SLAB_MAX_CLUSTER = 16;
constexpr int SLAB_MAX_THREADS = 512;
constexpr int SLAB_KNOT_STRIDE = KB + (32 - 2 * NN % 32) % 32;
static_assert(SLAB_KNOT_STRIDE % 32 == NN % 32 && SLAB_KNOT_STRIDE % 4 == 0,
              "slab knot stride");

// bytes of a CTA's dynamic shared memory at kc knots (see
// slab_cluster_plan): four mbarriers, the own knots' Pinv and S blocks,
// the r rows with two halo rows on each side, the u rows with one, the warp
// sums and (rank 0) every CTA's
__host__ __device__ constexpr int slab_smem_bytes(int kc) {
  return 32 + 4 * (2 * SLAB_KNOT_STRIDE * kc + (2 * kc + 6) * NX + 3 * 32 +
                   3 * SLAB_MAX_CLUSTER);
}

// a bulk copy (TMA) of `bytes` from global to this CTA's shared memory,
// completing on its mbarrier
__device__ inline void bulk_g2s(void* dst, const void* src, int bytes,
                                uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// sum_j M[j] x[j] in j order, M and x NX floats 8-byte aligned: both rows
// loaded first, then the fma chain
__device__ inline float row_dot(const float* M, const float* x) {
  float2 mv[NX / 2], xv[NX / 2];
#pragma unroll
  for (int jj = 0; jj < NX / 2; ++jj) mv[jj] = reinterpret_cast<const float2*>(M)[jj];
#pragma unroll
  for (int jj = 0; jj < NX / 2; ++jj) xv[jj] = reinterpret_cast<const float2*>(x)[jj];
  float acc = 0.f;
#pragma unroll
  for (int jj = 0; jj < NX / 2; ++jj) {
    acc += mv[jj].x * xv[jj].x;
    acc += mv[jj].y * xv[jj].y;
  }
  return acc;
}

// Row c of the banded product at knot k, M3 the knot's three blocks (k-1,
// k, k+1) and xe its row k-1 (rows k-1, k, k+1 follow): (centre + left) +
// right, the order of K2's btd_row.
__device__ inline float band_row(const float* M3, const float* xe, int c) {
  const float cc = row_dot(M3 + NN + c * NX, xe + NX);
  const float l = row_dot(M3 + c * NX, xe);
  const float r = row_dot(M3 + 2 * NN + c * NX, xe + 2 * NX);
  return (cc + l) + r;
}

__global__ void __launch_bounds__(SLAB_MAX_THREADS, 1)
pcg_slab_kernel(float* __restrict__ x, float* __restrict__ r,
                float* __restrict__ p, float* __restrict__ s,
                float* __restrict__ u, float* __restrict__ w,
                const float* __restrict__ S, const float* __restrict__ Pinv,
                int sys_bstride, const float* __restrict__ flp,
                const float* __restrict__ frp, const float* __restrict__ PinvL,
                const float* __restrict__ PinvR, const float* __restrict__ tot,
                int tot_bstride, float* __restrict__ scal,
                int* __restrict__ iters, float* __restrict__ dots,
                float* __restrict__ pkt, int L, int kc, int max_iter,
                const float* __restrict__ tol_p, int rnorm, int init) {
  extern __shared__ __align__(16) float sh[];
  const int b = blockIdx.y, tid = threadIdx.x, nth = blockDim.x;
  // the exit test and the cap first: the same for every CTA of the shard
  float alpha = 0.f, beta = 0.f, eta = 0.f;
  int it = 0;
  if (!init) {
    tot += (size_t)b * tot_bstride;
    eta = tot[0];
    const float d = tot[1], rr = tot[2], tol = *tol_p;
    const bool done = rnorm ? rr < tol * tol : fabsf(eta) < tol;
    it = iters[b];
    if (done || it >= max_iter) return;
    if (it == 0) {
      alpha = eta / d;
    } else {
      beta = eta / scal[2 * b];
      alpha = eta / (d - beta * eta / scal[2 * b + 1]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = L * NX;
  // shard b: its rows, system and packets
  x += (size_t)b * n;
  r += (size_t)b * n;
  p += (size_t)b * n;
  s += (size_t)b * n;
  u += (size_t)b * n;
  w += (size_t)b * n;
  S += (size_t)b * sys_bstride;
  Pinv += (size_t)b * sys_bstride;
  flp += (size_t)b * 6 * NX;
  frp += (size_t)b * 6 * NX;
  PinvL += (size_t)b * KB;
  PinvR += (size_t)b * KB;
  pkt += (size_t)b * 12 * NX;
  // this CTA's knots [k0, k0 + nk), and where its neighbours are
  const int k0 = rank * kc, nk = max(0, min(kc, L - k0));
  const bool first = nk > 0 && k0 == 0, last = nk > 0 && k0 + nk == L;
  const bool has_left = nk > 0 && k0 > 0, has_right = nk > 0 && k0 + nk < L;
  // mbarriers: the blocks, the r halo, the u halo, (rank 0) the CTA sums
  uint64_t* bar = reinterpret_cast<uint64_t*>(sh);
  float* Pb = sh + 8;                          // own knots' Pinv blocks
  float* Sb = Pb + SLAB_KNOT_STRIDE * kc;      // and S blocks
  float* re = Sb + SLAB_KNOT_STRIDE * kc;      // r rows k0-2 .. k0+kc+1
  float* ue = re + (kc + 4) * NX;              // u rows k0-1 .. k0+kc
  float* wpart = ue + (kc + 2) * NX;           // per warp: r.u, w.u, r.r
  float* cpart = wpart + 3 * 32;               // (rank 0) every CTA's sums
  if (tid == 0) {
    for (int q = 0; q < 4; ++q) mbar_init(bar + q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_tx(bar, 2 * nk * KB * 4);
    const int halo = ((has_left ? 1 : 0) + (has_right ? 1 : 0)) * NX * 4;
    mbar_arrive_tx(bar + 1, halo);
    mbar_arrive_tx(bar + 2, halo);
    if (rank == 0) mbar_arrive_tx(bar + 3, 3 * 4 * (C - 1));
  }
  __syncwarp();
  // the bulk copies of knot q's blocks, by lane q of warp 0
  if (tid < 32) {
    for (int q = tid; q < nk; q += 32) {
      bulk_g2s(Pb + q * SLAB_KNOT_STRIDE, Pinv + (size_t)(k0 + q) * KB, KB * 4, bar);
      bulk_g2s(Sb + q * SLAB_KNOT_STRIDE, S + (size_t)(k0 + q) * KB, KB * 4, bar);
    }
  }
  // every CTA's mbarriers initialised before the first st.async (waited
  // for below, after the axpy)
  __syncwarp();
  cluster_arrive_relaxed();
  // this thread's row: own knot kk, row i (shard row g); the entries of the
  // shard's edges (packet rows, u_{-1}, u_L) go to the idle threads first
  const int rows = nk * NX;
  const bool own = tid < rows;
  const int kk = tid / NX, i = tid - kk * NX, g = (k0 + kk) * NX + i;
  const int e0 = tid >= rows ? tid - rows : tid - rows + nth;
  float ri = 0.f, si = 0.f;
  if (own) {
    const float pi = u[g] + beta * p[g];
    si = w[g] + beta * s[g];
    x[g] += alpha * pi;
    ri = r[g] - alpha * si;
    p[g] = pi;
    s[g] = si;
    r[g] = ri;
    re[(kk + 2) * NX + i] = ri;
  }
  // the neighbour shards' rows -2, -1 and L, L+1 after the same update
  for (int e = e0; e < 4 * NX; e += nth) {
    const int row = e / NX, c = e - row * NX, j = row & 1;
    if (row < 2 ? !first : !last) continue;
    const float* pk = row < 2 ? flp : frp;
    re[(row < 2 ? j : nk + 2 + j) * NX + c] =
        pk[j * NX + c] - alpha * (pk[(2 + j) * NX + c] + beta * pk[(4 + j) * NX + c]);
  }
  __syncwarp();
  cluster_wait();
  // the edge rows of r into the neighbours' halo rows (the left one holds kc
  // knots: its right halo row is kc + 2)
  if (own && kk == 0 && has_left)
    st_async(cluster_u32(re + (kc + 2) * NX + i, rank - 1), ri,
             cluster_u32(bar + 1, rank - 1));
  if (own && kk == nk - 1 && has_right)
    st_async(cluster_u32(re + NX + i, rank + 1), ri, cluster_u32(bar + 1, rank + 1));
  __syncthreads();
  if (nk > 0) {
    mbar_wait(bar, 0);
    mbar_wait(bar + 1, 0);
  }
  float ui = 0.f;
  if (own) {
    ui = band_row(Pb + kk * SLAB_KNOT_STRIDE, re + (kk + 1) * NX, i);
    ue[(kk + 1) * NX + i] = ui;
  }
  // the off-slab rows u_{-1}, u_L from the neighbour shards' boundary Pinv rows
  for (int e = e0; e < 2 * NX; e += nth) {
    if (e < NX) {
      if (first) ue[e] = band_row(PinvL, re, e);
    } else if (last) {
      ue[(nk + 1) * NX + e - NX] = band_row(PinvR, re + (nk + 1) * NX, e - NX);
    }
  }
  if (own && kk == 0 && has_left)
    st_async(cluster_u32(ue + (kc + 1) * NX + i, rank - 1), ui,
             cluster_u32(bar + 2, rank - 1));
  if (own && kk == nk - 1 && has_right)
    st_async(cluster_u32(ue + i, rank + 1), ui, cluster_u32(bar + 2, rank + 1));
  __syncthreads();
  if (nk > 0) mbar_wait(bar + 2, 0);
  float ru = 0.f, wu = 0.f, rr = 0.f;
  if (own) {
    const float wi = band_row(Sb + kk * SLAB_KNOT_STRIDE, ue + kk * NX, i);
    u[g] = ui;
    w[g] = wi;
    ru += ri * ui;
    wu += wi * ui;
    rr += ri * ri;
    // the packets this shard sends: [r, w, s] x [second, edge] rows, last
    // two (to the right) then first two (to the left)
    const int k = k0 + kk;
    if (k >= L - 2) {
      float* pl = pkt + (k - (L - 2)) * NX + i;
      pl[0] = ri;
      pl[2 * NX] = wi;
      pl[4 * NX] = si;
    }
    if (k < 2) {
      float* pf = pkt + 6 * NX + k * NX + i;
      pf[0] = ri;
      pf[2 * NX] = wi;
      pf[4 * NX] = si;
    }
  }
  // the dots: warp sums, the CTA's in warp order, then the cluster's in rank
  // order by rank 0
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ru += __shfl_down_sync(0xffffffffu, ru, o);
    wu += __shfl_down_sync(0xffffffffu, wu, o);
    rr += __shfl_down_sync(0xffffffffu, rr, o);
  }
  const int lane = tid & 31, wid = tid >> 5, nw = nth >> 5;
  if (lane == 0) {
    wpart[3 * wid] = ru;
    wpart[3 * wid + 1] = wu;
    wpart[3 * wid + 2] = rr;
  }
  __syncthreads();
  // the CTA's sums into rank 0's slot of this rank (rank 0's own by a
  // plain store), completing on rank 0's fourth mbarrier
  if (tid < 3) {
    float v = 0.f;
    for (int q = 0; q < nw; ++q) v += wpart[3 * q + tid];
    if (rank == 0) {
      cpart[tid] = v;
      mbar_wait(bar + 3, 0);
    } else {
      st_async(cluster_u32(cpart + 3 * rank + tid, 0), v, cluster_u32(bar + 3, 0));
    }
  }
  // rank 0's threads 0..2 arrive once every CTA's sums are in: the others
  // leave then (their pushes delivered), and rank 0 adds them in rank order
  __syncwarp();
  cluster_arrive_relaxed();
  if (rank == 0 && tid < 3) {
    float v[SLAB_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < SLAB_MAX_CLUSTER; ++q) v[q] = q < C ? cpart[3 * q + tid] : 0.f;
    float t = v[0];
#pragma unroll
    for (int q = 1; q < SLAB_MAX_CLUSTER; ++q)
      if (q < C) t += v[q];
    dots[3 * b + tid] = t;
    if (!init && tid == 0) {
      scal[2 * b] = eta;
      scal[2 * b + 1] = alpha;
      iters[b] = it + 1;
    }
  }
  cluster_wait();
}

}  // namespace

// n_shard shards, one cluster of `cluster` CTAs each, kc knots and `threads`
// threads per CTA, smem bytes of dynamic shared memory (at least
// slab_smem_bytes(kc); ops/pcg_slab_cuda.py::slab_cluster_plan): shard b
// steps the b-th (L, NX) slab of x, r, p, s, u, w, reads its system from S /
// Pinv + b sys_bstride (L knots of 3 NX x NX blocks, 16-byte aligned), its
// packets flp, frp (6, NX), its neighbours' Pinv rows PinvL, PinvR (3, NX,
// NX), the summed dots tot + b tot_bstride (eta, d, r.r), its scalars scal
// (eta_prev, alpha_prev) and iters[b], and writes its partial dots (3) and
// packets pkt (2, 6, NX).  A shape the plan does not describe is refused
// (cudaErrorInvalidValue); one the card cannot hold fails the launch.
extern "C" int pcg_slab_launch(float* x, float* r, float* p, float* s,
                               float* u, float* w, const float* S,
                               const float* Pinv, int sys_bstride,
                               const float* flp, const float* frp,
                               const float* PinvL, const float* PinvR,
                               const float* tot, int tot_bstride, float* scal,
                               int* iters, float* dots, float* pkt, int L,
                               int n_shard, int cluster, int kc, int threads,
                               int smem, int max_iter, const float* tol,
                               int rnorm, int init, void* stream) {
  if (cluster < 1 || cluster > SLAB_MAX_CLUSTER || (cluster & (cluster - 1)) ||
      kc < 1 || cluster * kc < L || threads < NX * kc ||
      threads > SLAB_MAX_THREADS || threads % 32 != 0 ||
      smem < slab_smem_bytes(kc))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      pcg_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        pcg_slab_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(cluster, n_shard, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pcg_slab_kernel, x, r, p, s, u, w, S, Pinv,
                           sys_bstride, flp, frp, PinvL, PinvR, tot,
                           tot_bstride, scal, iters, dots, pkt, L, kc, max_iter,
                           tol, rnorm, init);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
