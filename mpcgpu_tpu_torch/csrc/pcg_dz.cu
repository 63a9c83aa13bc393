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
// iterations, each a BTD matvec with S and one with Pinv (2 x 3 x NX x NX x N
// floats: 301 KB at N = 64, 2.4 MB at N = 512 for NX = 14) and two
// reductions over N x NX values.  The work of one iteration is ~76 K
// multiply-adds at N = 64 and NX = 14: what
// bounds it is the latency of the dependent steps and the rate at which the
// matrices reach the multipliers, not the card's peak.
//
// Design: ONE THREAD-BLOCK CLUSTER per solve.  The plan (C CTAs, kp knots
// per CTA, the dynamic shared memory) is a fixed function of N, computed by
// ops/pcg_cuda.py::k2_cluster_plan and passed in: C = min(16, the power of
// two >= N / 8), kp = ceil(N / C) (8 x 8 at N = 64, 16 x 32 at N = 512), so
// only the trailing CTAs hold fewer knots (or none).  CTA r owns knots
// [r kp, min(N, (r + 1) kp)), one thread per row, and keeps their S and
// Pinv blocks in its own shared memory for the whole solve (loaded once,
// transposed, a knot's 3 NX^2 floats padded to KNOT_STRIDE = 32 m + NX
// floats, 590 = 18 x 32 + 14 at NX = 14, so that consecutive threads, on
// consecutive rows, read consecutive banks), together with its rows of lam,
// r, p, z, Sp and one halo row of r and p on each side.  A CG step reads only shared memory.
// What crosses CTAs are the neighbours' boundary rows of Sp and z and the
// warp parts of the three sums, and they travel by PUSH: the producing
// thread writes them into the consumer's shared memory with st.async, which
// completes its bytes on the consumer's mbarrier of that round; the
// consumer's warps each arrive once (warp 0 with the bytes it expects) and
// wait on the phase.  So a CG step has two rounds and no cluster barrier
// (on an H100 a cluster barrier with release/acquire costs ~1000-1600
// cycles, tools/torch_port_sync_microbench.py; a whole round, work
// included, ~1600):
//   A  Sp = S p; Sp's boundary rows and the warp parts of p.Sp go out; wait
//   B  alpha = eta / (the sum); lam, r, and the halo rows of r from the
//      neighbours' Sp (the same fmaf as the owner: the copies equal the
//      owner's bits); __syncthreads
//   C  z = Pinv r; z's boundary rows and the parts of r.z, r.r go out; wait
//   D  eta', done, beta; p, and the halo rows of p from the neighbours' z;
//      __syncthreads.
// A sum over the cluster is formed alike in every thread of every CTA: each
// CTA's part as block_sum forms a block's sum (warp shuffles, then the warp
// parts halved 16, 8, 4, 2, 1), then the C parts in rank order.  Every CTA thus forms alpha, eta', beta and `done` from
// the same bits in the same order and takes the same exit; a CTA that left
// one step early would wait forever on its next round (mbar_wait traps
// instead, so the launch fails).  One buffer per round suffices: a CTA
// writes round A of step i + 1 into a neighbour only after that neighbour
// sent its round C of step i, which it does after reading round A of step
// i (and likewise for round C).  z0 and eta0 are a round C before the
// first step.  The halo rows of r0 and the dz epilogue's lam row go by
// plain remote stores before a cluster barrier (once per solve each); the
// barrier after r0 also orders every CTA's mbarrier initialisation before
// the first st.async, and the last one keeps every CTA resident until all
// remote stores have landed.
//
// Limits: kp <= K2_MAX_KP (32) knots per CTA (5000 B of shared memory per
// knot plus ~1 KB: 163 KB at kp = 32); N > 128 needs C = 16, a non-portable
// cluster size (cudaFuncAttributeNonPortableClusterSizeAllowed), which the
// launch requests; a cluster shape the card cannot hold makes the launch
// fail with its cudaError_t, and the wrapper raises.  The launch goes
// through cudaLaunchKernelEx with a cluster-dimension attribute (capturable
// in a CUDA graph).
//
// K8b is the same template over a (C, B) grid, the cluster along x and the
// instance along y (kBatch): every cluster runs its own CG scalars and stops
// at its own exit, so each instance's lam, iters and exit flag equal those
// of K2' bit for bit.
//
// The edge blocks S[0,0] and S[N-1,2] are skipped by explicit bounds, not
// relied on to be zero.  The dz recovery computes, with lam_{N} = 0 and no
// du at the last knot,
//   dx_k = Qinv_k (q_k - lam_k + A_k^T lam_{k+1}),
//   du_k = (r_cost u_k + B_k^T lam_{k+1}) / (r_cost + rho).
// Each CTA recovers its own knots, lam_{k+1} of its last knot pushed by the
// right neighbour.
//
// K6 (dz_warp_kernel) is latency-bound: it reads Qinv, A, B (~2.5 x NX x NX
// x N floats, 0.14 MB at N = 64) once and does ~1 KFLOP per knot at NX =
// 14, a bound of ~0.04 us against ~1.3-1.8 us for a launch that returns at
// once in a CUDA graph.  What it can save is its own latency: A WARP PER
// KNOT, a few knots per CTA (ops/pcg_cuda.py::dz_plan), and ONE ROUND TRIP
// to memory: after griddepcontrol.wait the warp's lanes copy every input of
// its knot at once by cp.async into the knot's slot of shared memory
// (Qinv and A in 16-byte chunks, B, q, lam and lam_{k+1} in 8-byte ones, u,
// rho and the last flag in 4-byte ones; the wrapper refuses base addresses
// those chunks cannot take), wait once, and compute from shared memory
// only: lanes 0..NX-1 the right-hand side (into the slot's rhs row, one
// __syncwarp) and then dx, lanes NX..NX+NU-1 du in the same pass; no block
// barrier.  It is launched with programmatic dependent launch (the
// programmatic-stream-serialization attribute): its CTAs may be scheduled
// while the preceding kernel drains, and griddepcontrol.wait, before which
// nothing is loaded, holds them until that kernel's writes are visible.
// The per-output arithmetic is K2's epilogue (the same device functions on
// shared-memory rows), so K6 on K2's lam equals K2's dz bit for bit.
//
// K8c replaces mpcgpu_tpu/parallel/batched_fused.py::compute_dz_batched:
// dz_warp_kernel over a (CTA, instance) grid with a per-instance rho
// (rho_bstride 1), so each instance's dz equals K6's on its blocks bit for
// bit.  K8b replaces
// batched_fused.py::pcg_solve_batched_lanes (_make_pcg_kernel_packed:
// instances packed on lanes with segmented reductions, emulated here by
// one cluster per instance).
//
// K9b replaces mpcgpu_tpu/solver/kkt_pallas.py::compute_dz_pallas_slab
// (_make_dz_kernel with boundary_masks=True), the dz recovery of one knot
// shard's slab in the knot-sharded SQP.  It is dz_warp_kernel over a (CTA,
// shard) grid where lam_{k+1} comes from a second input, the shard's lam
// shifted by one knot with the right neighbour's first row appended (the
// halo the caller exchanged), and "k is the last knot" from a runtime flag
// per knot.  The blocks Qinv, A, B, q are read in place from K9a's
// halo-extended slabs (a knot stride between shards).  Its dz equals K6's
// on the same rows bit for bit (the same device functions).
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

using namespace mpc;
namespace cg = cooperative_groups;

namespace {

constexpr int NN = NX * NX;
// one knot's three blocks in a CTA's shared memory, transposed, padded to
// the least 32 m + NX floats that hold them, so that knot kk + 1 starts NX
// banks after knot kk (590 = 18 x 32 + 14 at NX = 14)
constexpr int KNOT_STRIDE = (3 * NN - NX + 31) / 32 * 32 + NX;
static_assert(KNOT_STRIDE >= 3 * NN && KNOT_STRIDE % 32 == NX % 32, "knot stride");
constexpr int K2_MAX_KP = 32;         // 16 x 32 = 512 = MAX_KNOTS
constexpr int K2_MAX_CLUSTER = 16;

// one thread per own row of the CTA, in whole warps
__host__ __device__ constexpr int k2_threads(int kp) {
  return NX * kp <= 32 ? 32 : (NX * kp + 31) / 32 * 32;
}
constexpr int K2_MAX_THREADS = k2_threads(K2_MAX_KP);
static_assert(K2_MAX_THREADS / 32 <= 16, "cluster_sum sums at most 16 warp parts");

// floats of a CTA's dynamic shared memory at kp knots (see k2_cluster_plan)
__host__ __device__ constexpr int k2_smem_floats(int kp) {
  return 4                        // two mbarriers (8 B each)
         + 2 * KNOT_STRIDE * kp   // S, Pinv
         + 2 * NX * (kp + 2)      // r, p with a halo row on each side
         + 3 * NX * kp            // lam, z, Sp
         + 4 * NX                 // the neighbours' boundary rows of Sp, z
         + 3 * K2_MAX_CLUSTER * (k2_threads(kp) / 32);  // warp parts, 3 sums
}

// One knot's slot of dz_warp_kernel's shared memory (floats from the slot's
// start): Qinv, A (16-byte chunks), B, q, lam_k, lam_{k+1} (8-byte chunks),
// the rhs row, u, rho, the last flag (4-byte), padded to 16 bytes
constexpr int DZ_QINV = 0;
constexpr int DZ_A = NN;
constexpr int DZ_B = 2 * NN;
constexpr int DZ_Q = DZ_B + NX * NU;
constexpr int DZ_LAM = DZ_Q + NX;
constexpr int DZ_LAMN = DZ_LAM + NX;
constexpr int DZ_RHS = DZ_LAMN + NX;
constexpr int DZ_U = DZ_RHS + NX;
constexpr int DZ_RHO = DZ_U + NU;
constexpr int DZ_LAST = DZ_RHO + 1;
constexpr int DZ_KNOT_FLOATS = (DZ_LAST + 1 + 3) / 4 * 4;
constexpr int DZ_MAX_KPC = 8;         // knots (warps) per CTA
static_assert(NN % 4 == 0 && DZ_B % 2 == 0 && DZ_Q % 2 == 0 && DZ_LAM % 2 == 0 &&
              DZ_LAMN % 2 == 0, "chunks of 16 and 8 bytes");
static_assert(W <= 32, "one lane per output of a knot");

// An asynchronous copy of kBytes from global to shared memory (cp.async;
// the 16-byte copy bypasses L1)
template <int kBytes>
__device__ inline void cp_async(float* dst, const float* src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(kBytes) : "memory");
}

// n floats from src to dst in kBytes chunks, spread over the warp's lanes
template <int kBytes, int n>
__device__ inline void stage(float* dst, const float* src, int lane) {
  constexpr int F = kBytes / 4;
  static_assert(n % F == 0, "whole chunks");
  FOR_STRIDED(e, lane, n / F, 32) cp_async<kBytes>(dst + e * F, src + e * F);
}

// Programmatic dependent launch: wait until the preceding kernel of the
// stream has completed and its writes are visible (returns at once for a
// launch without the attribute)
__device__ inline void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

// row i of knot kk's BTD product with a CTA's transposed blocks Mt (knot kk
// at kk KNOT_STRIDE, band b at b NN, entry (i, j) at j NX + i) and the
// extended vector x (row kk + 1 is knot kk; rows 0 and nk + 1 the halos);
// k the global knot.  (center + left) + right
__device__ inline float btd_row_t(const float* Mt, const float* x, int kk,
                                  int i, int k, int N) {
  const float* Mk = Mt + kk * KNOT_STRIDE;
  const float* xk = x + kk * NX;
  float c = 0.f, l = 0.f, r = 0.f;
#pragma unroll
  for (int j = 0; j < NX; ++j) c = fmaf(Mk[NN + j * NX + i], xk[NX + j], c);
  if (k > 0) {
#pragma unroll
    for (int j = 0; j < NX; ++j) l = fmaf(Mk[j * NX + i], xk[j], l);
  }
  if (k < N - 1) {
#pragma unroll
    for (int j = 0; j < NX; ++j) r = fmaf(Mk[2 * NN + j * NX + i], xk[2 * NX + j], r);
  }
  return (c + l) + r;
}

// One round of the cluster's sums: the warp's part of each of kV sums
// (warp shuffles) goes to slot [rank][warp] of `parts` (kV planes of 16 x nw
// floats) in every CTA: by st.async to the others, completing on their
// mbarrier `bar`, and by a plain store plus an arrive to this CTA's own.
// Warp 0's arrive also sets the bytes this CTA expects from the others
// (their parts, and `halo_bytes` of the neighbours' rows).
template <int kV>
__device__ inline void push_parts(float a, float b, float* parts, uint64_t* bar,
                                  int C, int rank, int nw, int halo_bytes) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    if (kV > 1) b += __shfl_down_sync(0xffffffffu, b, o);
  }
  a = __shfl_sync(0xffffffffu, a, 0);
  if (kV > 1) b = __shfl_sync(0xffffffffu, b, 0);
  const int slot = rank * nw + w, plane = K2_MAX_CLUSTER * nw;
  if (lane < C && lane != rank) {
    const uint32_t mbar = cluster_u32(bar, lane);
    st_async(cluster_u32(parts + slot, lane), a, mbar);
    if (kV > 1) st_async(cluster_u32(parts + plane + slot, lane), b, mbar);
  } else if (lane == rank) {
    parts[slot] = a;
    if (kV > 1) parts[plane + slot] = b;
    if (w == 0)
      mbar_arrive_tx(bar, (C - 1) * nw * kV * 4 + halo_bytes);
    else
      mbar_arrive(bar);
  }
}

// the sum over the cluster of a round's parts, the same bits in every
// thread of every CTA: lane q < C sums rank q's warp parts as block_sum
// sums a block's (the 32 slots, zero-padded, halved 16, 8, 4, 2, 1; nw <=
// 16, so the first halving adds zeros), then every lane adds the C rank
// sums in rank order 0..C-1
__device__ inline float cluster_sum(const float* parts, int C, int nw) {
  const int lane = threadIdx.x & 31;
  float v[16];
#pragma unroll
  for (int w = 0; w < 16; ++w)
    v[w] = (lane < C && w < nw ? parts[lane * nw + w] : 0.f) + 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) v[w] += v[w + 8];
#pragma unroll
  for (int w = 0; w < 4; ++w) v[w] += v[w + 4];
  v[0] += v[2];
  v[1] += v[3];
  v[0] += v[1];
  float total = 0.f;
  for (int q = 0; q < C; ++q) total += __shfl_sync(0xffffffffu, v[0], q);
  return total;
}

// kBatch: blockIdx.y is an instance (K8b); without it the kernel reads its
// pointers as given, so K2 and K2' keep them in the parameter bank
template <bool kDz, bool kBatch>
__global__ void __launch_bounds__(K2_MAX_THREADS, 1)
pcg_dz_kernel(const float* __restrict__ S, const float* __restrict__ Pinv,
              const float* __restrict__ gamma, const float* __restrict__ lam0,
              const float* __restrict__ Qinv, const float* __restrict__ A,
              const float* __restrict__ B, const float* __restrict__ q,
              const float* __restrict__ u, int u_stride,
              const float* __restrict__ rho_p, float r_cost, int max_iter,
              const float* __restrict__ tol_p, int rnorm, int N, int kp,
              float* __restrict__ lam_o, float* __restrict__ dz,
              int* __restrict__ iters_o, int* __restrict__ conv_o) {
  extern __shared__ __align__(16) float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, nth = blockDim.x, nw = nth >> 5;
  // instance blockIdx.y (K8b): its own system, its own CG scalars and exit
  const int b = kBatch ? blockIdx.y : 0;
  if constexpr (kBatch) {
    S += (size_t)b * N * 3 * NN;
    Pinv += (size_t)b * N * 3 * NN;
    gamma += (size_t)b * N * NX;
    lam0 += (size_t)b * N * NX;
    lam_o += (size_t)b * N * NX;
  }
  // this CTA's knots [k0, k0 + nk); whether it has neighbours' rows
  const int k0 = rank * kp;
  const int nk = max(0, min(kp, N - k0));
  const int nrow = nk * NX;
  const bool has_left = nk > 0 && k0 > 0;
  const bool has_right = nk > 0 && k0 + nk < N;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sh);   // rounds A (p.Sp), C (r.z)
  float* St = sh + 4;
  float* Pt = St + KNOT_STRIDE * kp;
  float* r = Pt + KNOT_STRIDE * kp;      // (kp + 2) rows: halo, own, halo
  float* p = r + NX * (kp + 2);
  float* lam = p + NX * (kp + 2);
  float* z = lam + NX * kp;
  float* Sp = z + NX * kp;
  // written by the neighbours: their boundary rows of Sp and z (left: the
  // left neighbour's last row; right: the right one's first row)
  float* Sp_lh = Sp + NX * kp;
  float* Sp_rh = Sp_lh + NX;
  float* z_lh = Sp_rh + NX;
  float* z_rh = z_lh + NX;
  float* partsA = z_rh + NX;                     // p.Sp: 16 x nw
  float* partsC = partsA + K2_MAX_CLUSTER * nw;  // r.z, r.r: 2 x 16 x nw
  const int halo_bytes = ((has_left ? 1 : 0) + (has_right ? 1 : 0)) * NX * 4;
  const float tol = *tol_p;

  if (tid == 0) {
    mbar_init(bar, nw);
    mbar_init(bar + 1, nw);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // S and Pinv of the own knots, transposed; lam0 over the own knots and
  // their halos into p (the extended vector of the first product)
  for (int e = tid; e < nk * 3 * NN; e += nth) {
    const int kk = e / (3 * NN), f = e - kk * 3 * NN;
    const int band = f / NN, ij = f - band * NN, i = ij / NX, j = ij - i * NX;
    const int dst = kk * KNOT_STRIDE + band * NN + j * NX + i;
    St[dst] = S[(size_t)k0 * 3 * NN + e];
    Pt[dst] = Pinv[(size_t)k0 * 3 * NN + e];
  }
  for (int e = tid; e < (nk + 2) * NX; e += nth) {
    const int g = (k0 - 1) * NX + e;     // global row of extended row e
    const bool in = nk > 0 && g >= 0 && g < N * NX;
    p[e] = in ? lam0[g] : 0.f;
    if (in && e >= NX && e < (nk + 1) * NX) lam[e - NX] = lam0[g];
  }
  __syncthreads();
  // this thread's row i of own knot kk (global k); the boundary rows push
  // their values into the neighbours' halo rows and buffers
  const int kk = tid / NX, i = tid - kk * NX, k = k0 + kk;
  const bool own = tid < nrow;
  const bool push_l = own && kk == 0 && has_left;
  const bool push_r = own && kk == nk - 1 && has_right;
  const int nb = push_l ? rank - 1 : push_r ? rank + 1 : rank;
  // st.async targets of a boundary row: the neighbour's Sp and z halo
  // buffers and its mbarriers of rounds A and C
  const bool push = push_l || push_r;
  const uint32_t Sp_to = push ? cluster_u32((push_l ? Sp_rh : Sp_lh) + i, nb) : 0;
  const uint32_t z_to = push ? cluster_u32((push_l ? z_rh : z_lh) + i, nb) : 0;
  const uint32_t barA_to = cluster_u32(bar, nb), barC_to = cluster_u32(bar + 1, nb);
  if (own) {
    const float ri = gamma[(size_t)k0 * NX + tid] - btd_row_t(St, p, kk, i, k, N);
    r[NX + tid] = ri;
    // r0 straight into the neighbours' halo rows of r (the left one's last
    // extended row, the right one's first)
    if (push_l) cluster.map_shared_rank(r, rank - 1)[(kp + 1) * NX + i] = ri;
    if (push_r) cluster.map_shared_rank(r, rank + 1)[i] = ri;
  }
  // r0's halo rows landed, and every CTA's mbarriers are initialised
  // before the first st.async
  cluster.sync();
  // z0 = Pinv r0 and eta0 (rr0): round C, phase 0
  float rz = 0.f, rr = 0.f;
  if (own) {
    const float ri = r[NX + tid], zi = btd_row_t(Pt, r, kk, i, k, N);
    z[tid] = zi;
    p[NX + tid] = zi;
    if (push) st_async(z_to, zi, barC_to);
    rz = ri * zi;
    rr = ri * ri;
  }
  push_parts<2>(rz, rr, partsC, bar + 1, C, rank, nw, halo_bytes);
  mbar_wait(bar + 1, 0);
  float eta = cluster_sum(partsC, C, nw);
  if (rnorm) rr = cluster_sum(partsC + K2_MAX_CLUSTER * nw, C, nw);
  bool done = rnorm ? rr < tol * tol : fabsf(eta) < tol;
  if (has_left && tid < NX) p[tid] = z_lh[tid];
  if (has_right && tid < NX) p[(nk + 1) * NX + tid] = z_rh[tid];
  __syncthreads();

  int it = 0;
  while (it < max_iter && !done) {
    // A: Sp = S p; the boundary rows of Sp and the parts of p.Sp go out
    float pSp = 0.f;
    if (own) {
      const float s = btd_row_t(St, p, kk, i, k, N);
      Sp[tid] = s;
      if (push) st_async(Sp_to, s, barA_to);
      pSp = p[NX + tid] * s;
    }
    push_parts<1>(pSp, 0.f, partsA, bar, C, rank, nw, halo_bytes);
    mbar_wait(bar, it & 1);
    // B: alpha; lam, r and r's halo rows
    const float alpha = eta / cluster_sum(partsA, C, nw);
    if (own) {
      lam[tid] = fmaf(alpha, p[NX + tid], lam[tid]);
      r[NX + tid] = fmaf(-alpha, Sp[tid], r[NX + tid]);
    }
    if (has_left && tid < NX) r[tid] = fmaf(-alpha, Sp_lh[tid], r[tid]);
    if (has_right && tid < NX)
      r[(nk + 1) * NX + tid] = fmaf(-alpha, Sp_rh[tid], r[(nk + 1) * NX + tid]);
    __syncthreads();
    // C: z = Pinv r; the boundary rows of z and the parts of r.z, r.r go out
    rz = 0.f;
    rr = 0.f;
    if (own) {
      const float ri = r[NX + tid], zi = btd_row_t(Pt, r, kk, i, k, N);
      z[tid] = zi;
      if (push) st_async(z_to, zi, barC_to);
      rz = ri * zi;
      rr = ri * ri;
    }
    push_parts<2>(rz, rr, partsC, bar + 1, C, rank, nw, halo_bytes);
    mbar_wait(bar + 1, (it + 1) & 1);
    // D: eta', the exit, beta; p and p's halo rows
    const float eta_new = cluster_sum(partsC, C, nw);
    if (rnorm) rr = cluster_sum(partsC + K2_MAX_CLUSTER * nw, C, nw);
    done = rnorm ? rr < tol * tol : fabsf(eta_new) < tol;
    const float beta = eta_new / eta;
    if (own) p[NX + tid] = fmaf(beta, p[NX + tid], z[tid]);
    if (has_left && tid < NX) p[tid] = fmaf(beta, p[tid], z_lh[tid]);
    if (has_right && tid < NX)
      p[(nk + 1) * NX + tid] = fmaf(beta, p[(nk + 1) * NX + tid], z_rh[tid]);
    eta = eta_new;
    ++it;
    __syncthreads();
  }

  if (own) lam_o[(size_t)k0 * NX + tid] = lam[tid];
  // lam_{k+1} of the last own knot: the right neighbour pushes its first
  // row into the right halo row of r, which no step reads any more.  The
  // barrier also keeps every CTA resident until all remote stores landed.
  if (kDz && push_l) cluster.map_shared_rank(r, rank - 1)[(kp + 1) * NX + i] = lam[tid];
  cluster.sync();
  if constexpr (kDz) {
    const float* lam_last = r + (nk + 1) * NX;
    const float* Ab = A + (size_t)k0 * NN;
    const float* qb = q + (size_t)k0 * NX;
    if (own) {
      const float* lam_n = kk + 1 < nk ? lam + (kk + 1) * NX : lam_last;
      z[tid] = dz_rhs(Ab, qb, lam, lam_n, k < N - 1, kk, i);
    }
    __syncthreads();
    if (own) dz[(size_t)k * W + i] = dz_dx(Qinv + (size_t)k0 * NN, z + kk * NX, kk, i);
    const float s_r = 1.f / (r_cost + *rho_p);
    for (int e = tid; e < nk * NU; e += nth) {
      const int kc = e / NU, c = e - kc * NU;
      const float* lam_n = kc + 1 < nk ? lam + (kc + 1) * NX : lam_last;
      dz[(size_t)(k0 + kc) * W + NX + c] =
          dz_du(B + (size_t)k0 * NX * NU, lam_n, k0 + kc < N - 1,
                u + (size_t)k0 * u_stride, u_stride, r_cost, s_r, kc, c);
    }
  }
  if (rank == 0 && tid == 0) {
    iters_o[b] = it;
    conv_o[b] = done ? 1 : 0;
  }
}

// K6, K8c and K9b: warp w of CTA (x, b) recovers knot x kpc + w of
// instance or shard b.  lam_next, lastm: K9b's lam_{k+1} rows and last-knot
// flags (N per shard), or nullptr (K6, K8c: the next row of lam, and k =
// N - 1).  The blocks of instance b start b sys_nstride knots on, its u b
// u_bstride floats on, its rho b rho_bstride.  Before griddepcontrol.wait
// only indices are computed: the inputs may be the preceding kernel's
// outputs.
__global__ void __launch_bounds__(32 * DZ_MAX_KPC)
dz_warp_kernel(const float* __restrict__ lam, const float* __restrict__ lam_next,
               const float* __restrict__ lastm, const float* __restrict__ Qinv,
               const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ q, int sys_nstride,
               const float* __restrict__ u, int u_stride, int u_bstride,
               const float* __restrict__ rho_p, int rho_bstride, float r_cost,
               int N, int kpc, float* __restrict__ dz) {
  extern __shared__ __align__(16) float sh[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.y, k = blockIdx.x * kpc + w;
  if (k >= N) return;
  float* s = sh + w * DZ_KNOT_FLOATS;
  const size_t kb = (size_t)b * sys_nstride + k;   // the knot's blocks
  const size_t kr = (size_t)b * N + k;             // its rows of lam, dz
  const bool slab = lastm != nullptr;
  griddep_wait();
  stage<16, NN>(s + DZ_QINV, Qinv + kb * NN, lane);
  stage<16, NN>(s + DZ_A, A + kb * NN, lane);
  stage<8, NX * NU>(s + DZ_B, B + kb * NX * NU, lane);
  stage<8, NX>(s + DZ_Q, q + kb * NX, lane);
  stage<8, NX>(s + DZ_LAM, lam + kr * NX, lane);
  // K6's last knot has no row lam_{k+1} (and reads none)
  if (slab)
    stage<8, NX>(s + DZ_LAMN, lam_next + kr * NX, lane);
  else if (k < N - 1)
    stage<8, NX>(s + DZ_LAMN, lam + (kr + 1) * NX, lane);
  stage<4, NU>(s + DZ_U, u + (size_t)b * u_bstride + (size_t)k * u_stride, lane);
  if (lane == 0) cp_async<4>(s + DZ_RHO, rho_p + (size_t)b * rho_bstride);
  if (slab && lane == 1) cp_async<4>(s + DZ_LAST, lastm + kr);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  const bool has_next = slab ? s[DZ_LAST] == 0.f : k < N - 1;
  float v = 0.f;
  if (lane < NX) {
    s[DZ_RHS + lane] = dz_rhs(s + DZ_A, s + DZ_Q, s + DZ_LAM, s + DZ_LAMN,
                              has_next, 0, lane);
  } else if (lane < W) {
    const float s_r = 1.f / (r_cost + s[DZ_RHO]);
    v = dz_du(s + DZ_B, s + DZ_LAMN, has_next, s + DZ_U, 0, r_cost, s_r, 0,
              lane - NX);
  }
  __syncwarp();
  if (lane < NX) v = dz_dx(s + DZ_QINV, s + DZ_RHS, 0, lane);
  if (lane < W) dz[kr * W + lane] = v;
}

// the cluster launch of K2 / K2' / K8b: cluster C CTAs of k2_threads(kp)
// threads along x, batch instances along y, smem bytes of dynamic shared
// memory (at least k2_smem_floats(kp) floats)
template <bool kDz, bool kBatch>
cudaLaunchConfig_t k2_config(int cluster, int kp, int smem, int batch,
                             void* stream, cudaLaunchAttribute* attr,
                             cudaError_t* err) {
  cudaLaunchConfig_t cfg = {};
  *err = cudaSuccess;
  if (cluster < 1 || cluster > K2_MAX_CLUSTER || (cluster & (cluster - 1)) ||
      kp < 2 || kp > K2_MAX_KP ||
      smem < static_cast<int>(sizeof(float)) * k2_smem_floats(kp)) {
    *err = cudaErrorInvalidValue;
    return cfg;
  }
  const auto kernel = pcg_dz_kernel<kDz, kBatch>;
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
  if (*err == cudaSuccess && cluster > 8)
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg.gridDim = dim3(cluster, batch, 1);
  cfg.blockDim = dim3(k2_threads(kp), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kDz, bool kBatch>
int pcg_launch_impl(const float* S, const float* Pinv, const float* gamma,
                    const float* lam0, const float* Qinv, const float* A,
                    const float* B, const float* q, const float* u,
                    int u_stride, const float* rho, float r_cost, int max_iter,
                    const float* tol, int rnorm, int N, int cluster, int kp,
                    int smem, int batch, float* lam, float* dz, int* iters,
                    int* conv, void* stream) {
  if (N < 2 || cluster * kp < N) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  const cudaLaunchConfig_t cfg =
      k2_config<kDz, kBatch>(cluster, kp, smem, batch, stream, attr, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, pcg_dz_kernel<kDz, kBatch>, S, Pinv, gamma,
                           lam0, Qinv, A, B, q, u, u_stride, rho, r_cost,
                           max_iter, tol, rnorm, N, kp, lam, dz, iters, conv);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pcg_dz_launch(const float* S, const float* Pinv,
                             const float* gamma, const float* lam0,
                             const float* Qinv, const float* A, const float* B,
                             const float* q, const float* u, int u_stride,
                             const float* rho, float r_cost, int max_iter,
                             const float* tol, int rnorm, int N, int cluster,
                             int kp, int smem, float* lam, float* dz,
                             int* iters, int* conv, void* stream) {
  return pcg_launch_impl<true, false>(S, Pinv, gamma, lam0, Qinv, A, B, q, u,
                                      u_stride, rho, r_cost, max_iter, tol,
                                      rnorm, N, cluster, kp, smem, 1, lam, dz,
                                      iters, conv, stream);
}

// batch instances, one cluster each (K8b; K2' is batch = 1): instance b
// solves the b-th (N, ...) slab of S, Pinv, gamma, lam0 into lam, iters[b],
// conv[b]
extern "C" int pcg_launch(const float* S, const float* Pinv,
                          const float* gamma, const float* lam0, int max_iter,
                          const float* tol, int rnorm, int N, int cluster,
                          int kp, int smem, int batch, float* lam, int* iters,
                          int* conv, void* stream) {
  const auto launch = batch > 1 ? pcg_launch_impl<false, true>
                                 : pcg_launch_impl<false, false>;
  return launch(S, Pinv, gamma, lam0, nullptr, nullptr, nullptr, nullptr,
                nullptr, 0, nullptr, 0.f, max_iter, tol, rnorm, N, cluster, kp,
                smem, batch, lam, nullptr, iters, conv, stream);
}

// how many clusters of K2 (dz = 1) or K2' (dz = 0) at this plan the card
// can hold at once (cudaOccupancyMaxActiveClusters), into *out
extern "C" int pcg_cluster_occupancy(int cluster, int kp, int smem, int dz,
                                     int* out) {
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  if (dz) {
    const cudaLaunchConfig_t cfg =
        k2_config<true, false>(cluster, kp, smem, 1, nullptr, attr, &err);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(out, pcg_dz_kernel<true, false>, &cfg);
  } else {
    const cudaLaunchConfig_t cfg =
        k2_config<false, false>(cluster, kp, smem, 1, nullptr, attr, &err);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(out, pcg_dz_kernel<false, false>, &cfg);
  }
  return static_cast<int>(err);
}

// K6 (lam_next, lastm nullptr; batch = 1; rho_bstride 0), K8c (batch
// instances, rho_bstride 1) and K9b (batch = shards, rho_bstride 0):
// dz_warp_kernel on the plan (ctas x batch CTAs of kpc warps, smem bytes of
// dynamic shared memory; ops/pcg_cuda.py::dz_plan), with programmatic
// dependent launch
extern "C" int dz_warp_launch(const float* lam, const float* lam_next,
                              const float* lastm, const float* Qinv,
                              const float* A, const float* B, const float* q,
                              int sys_nstride, const float* u, int u_stride,
                              int u_bstride, const float* rho, int rho_bstride,
                              float r_cost, int N, int batch, int kpc, int ctas,
                              int smem, float* dz, void* stream) {
  if (N < 2 || batch < 1 || kpc < 1 || kpc > DZ_MAX_KPC || ctas * kpc < N ||
      smem < static_cast<int>(sizeof(float)) * kpc * DZ_KNOT_FLOATS ||
      (lam_next == nullptr) != (lastm == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, batch, 1);
  cfg.blockDim = dim3(32 * kpc, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dz_warp_kernel, lam, lam_next, lastm, Qinv, A, B, q, sys_nstride,
      u, u_stride, u_bstride, rho, rho_bstride, r_cost, N, kpc, dz);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
