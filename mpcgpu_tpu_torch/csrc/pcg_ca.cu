// K10b and the coefficient step: one outer step (s CG iterations) of the
// communication-avoiding s-step CG on every knot shard's slab of the
// block-tridiagonal Schur system, the per-shard compute of the knot-sharded
// PCG's "ca_slab" form.
//
// K10b replaces the TPU kernel mpcgpu_tpu/ops/pcg_pallas.py::
// pcg_ca_basis_pallas (_make_ca_basis_kernel).  Per shard, on the slab
// extended by h = 2s+1 knots per side (the neighbours' p and z rows arrive
// as packets, their S and Pinv rows as halo blocks exchanged once per
// solve; the shard's own rows are read in place):
//   V = [p, (P^-1 S) p / g, ..., ]  (s+1 vectors),  W = [z, ...]  (s),
// each P^-1 S application one product by S (whose result is the exact
// S-image, kept: Vt, Wt) and one by Pinv, scaled by 1/g.  The products have
// zero (not ring) ends: the error at the ends of the extension moves one
// knot inward per product and, the extension being deeper than the 2s+1
// products, never reaches the local knots; at the global ends the ring-wrap
// rows meet the zero corner blocks S[0, 0] = Pinv[0, 0] = 0 and
// S[N-1, 2] = Pinv[N-1, 2] = 0.  It writes Y = [V | W] and Ytil = [Vt | Wt]
// on the local knots and the shard's Gram parts
//   [G = Y.Ytil (m^2) | b = Y.r (m) | F = Ytil.Ytil (m^2) | f = Ytil.r (m) |
//    r.r (1)],  m = 2s+1,
// each summed over the shard's rows in a fixed order (the TPU kernel leaves
// lane partials to XLA).  The mesh's psum of the parts stays outside: it is
// the collective.
//
// The coefficient step replaces the XLA ops around the TPU kernel in
// mpcgpu_tpu/parallel/pcg_sharded.py::_pcg_local_ca_slab (_ca_coeff_iters,
// the recovery, _ca_next_scale): from the summed parts it runs s masked
// exact-CG iterations in m dimensions (alpha = eta / (a.G a), e += alpha a,
// c -= alpha g T a, eta' = b.c - e.G c, r.r' = r.r - 2 f.e + e.F e,
// a = c + (eta'/eta) a; the exit |eta'| < tol, or r.r' < tol^2 for "rnorm",
// and the cap latch), then recovers x += Y e, r -= Ytil e, z = Y c,
// p = Y a, the next scale g (|G[s,s]| / |G[0,0]|)^(1/2s) clipped to
// [1e-6, 1e6], and writes the packets the shard sends next.  A shard whose
// exit fired, or that reached the cap, returns at once from both kernels
// and keeps its state, so a solve's whole cap is enqueued with no read-back.
//
// Where the port differs in precision: both kernels do the s-step algebra
// in f64 (the bases, their S-images, Y and Ytil, the parts, the coefficient
// iterations and the recovery's sums), from the f32 system and state, and
// round to f32 only the state they write (x, r, z, p, the packets).  The
// TPU kernel works in f32, where the monomial basis of P^-1 S loses the
// relations v_{j+1} = (P^-1 S v_j) / g that the coefficient recurrences
// assume: on the IIWA's Schur system an f32 s-step solve lands 0.38 (N =
// 64 over 4 shards) from the f64 solve where classic CG lands 5e-4, and
// on a well-conditioned system it loses its digits after one outer step;
// in f64 it takes classic CG's iteration counts (ROADMAP.md queue 3).  The
// card's f64 units make this nearly free: the work is bytes-bound.
//
// What bounds them on an H100: latency.  K10b reads the extended S and
// Pinv (2 x 3 x NX^2 x (L + 2h) floats, 386 KB at L = 64, s = 4, NX =
// 14) and does 2s+1 dependent banded products (4s block-row products per
// row in all), then 181 dot products over the shard's L x NX rows; the work is ~0.5
// MFLOP per shard at L = 64.  The coefficient step is a few hundred
// dependent f64 flops (s steps of m-term chains and two divisions), then
// an m-term combination per row over Y and Ytil (129 KB at L = 64).
//
// K10b's design: ONE THREAD-BLOCK CLUSTER PER SHARD (grid (C, n_shard), the
// cluster along x), laid out by ops/pcg_ca_cuda.py::ca_cluster_plan(L, s),
// a fixed function of (L, s): C CTAs (a power of two <= 16; 16 is a
// non-portable cluster size, which the launch requests), ke = ceil((L +
// 2h) / C) extended knots per CTA (only the trailing CTAs hold fewer, or
// none), two threads per own row (V's chain and W's) or, where they do not
// fit, one for both, and whether the CTA keeps its knots' S and Pinv in
// shared memory (loaded once per call by 16-byte loads and widened to f64
// there, so that no product converts; transposed and padded to
// CA_KNOT_STRIDE entries a knot as K2 keeps them, so that consecutive
// threads read consecutive words) or reads them from global memory (L2)
// where they do not fit (L = 512 on one shard).  A CTA keeps the four f64
// working vectors of its knots with one halo row on each side.  After each
// product the threads of its edge knots push their rows of the product
// (the V and, while it lasts, the W chain) into the neighbours' halo rows
// with the 8-byte st.async, completing on the neighbour's mbarrier of that
// phase (two, alternating): no cluster barrier per phase.  One buffer per
// array suffices: a CTA writes phase t + 2's rows into a neighbour only
// after reading that neighbour's phase t + 1 rows, which the neighbour's
// edge threads push after reading the rows of phase t (as K2's rounds).
// Each row's product is the parent's in the same order (a band's row and x
// loaded before the fma chain), so Y and Ytil are the same bits.  The Gram
// in one pass: each CTA keeps its local rows of Z = [Y | Ytil | r] (f64,
// 2m + 1 columns) in shared memory; thread d forms part d over the CTA's
// local rows (row r_lo + 4q + a into accumulator a, then ((a0 + a1) + (a2 +
// a3))); after a cluster barrier, rank 0 adds the C partials in rank order
// through distributed shared memory and writes `parts`; a second barrier
// keeps every CTA resident until rank 0 has read them.  Y and Ytil still go
// to global memory once: the coefficient step reads them after the mesh's
// psum.
//
// The coefficient step's design: ONE CLUSTER OF CTAs PER SHARD (grid (C,
// n_shard)), laid out by ops/pcg_ca_cuda.py::coeff_plan(L, s): the shard's
// NX L rows cut into C runs of R rows.  Every CTA runs the s iterations
// itself on its warp 0, from the same inputs in the same order, so every
// CTA holds the same coefficients with no exchange: lane q keeps row q of
// G and F in registers, every lane b, f and the coefficient vectors, and
// row q's products reach every lane by shuffles; nothing is read from
// global memory inside the loop.  Meanwhile the other warps load their
// first row's Y and Ytil, and rank 0's warp 1 forms the next scale (the
// pow); then each row thread recovers its rows and writes its packet
// entries.  Every sum keeps the parent's order, so every output is the
// parent's bits.  Every CTA reads scal, iters and done at entry and then
// arrives at the cluster barrier; rank 0 writes them after its wait at the
// end, so the writes follow every read.
#include <cooperative_groups.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

using namespace mpc;
namespace cg = cooperative_groups;

namespace {

constexpr int NN = NX * NX;
constexpr int MAX_S = 8;

// K10b's cluster plan limits (ops/pcg_ca_cuda.py): the largest cluster,
// the most threads of a CTA (two, or one, per own row), and the stride of
// a knot's S (or Pinv) in a CTA's shared memory, f64 entries: K2's
// KNOT_STRIDE (pcg_dz.cu), the least 32 m + NX >= 3 NN (590 = 18 x 32 + 14
// at NX = 14)
constexpr int CA_MAX_CLUSTER = 16;
constexpr int CA_MAX_THREADS = 512;
constexpr int CA_KNOT_STRIDE = 3 * NN + (NX - 3 * NN % 32 + 32) % 32;
static_assert(CA_KNOT_STRIDE >= 3 * NN && CA_KNOT_STRIDE % 32 == NX % 32,
              "ca knot stride");
// the block loads take a knot's 3 NN floats as float4s: 3 NN = 12 NQ^2
static_assert(3 * NN % 4 == 0, "a knot's blocks in whole float4s");
constexpr int CA_LOAD_BATCH = 8;    // block entries a thread loads at once
// the coefficient step's plan limits (ops/pcg_ca_cuda.py::coeff_plan): the
// largest cluster and the most threads of a CTA (warp 0 and the row warps)
constexpr int COEF_MAX_CLUSTER = 16;
constexpr int COEF_MAX_THREADS = 256;

// bytes of a CTA's dynamic shared memory at ke knots (see ca_cluster_plan):
// two mbarriers, the four f64 vectors with a halo row on each side, Z's
// rows of the own knots, the CTA's Gram partials, and (blocks) the own
// knots' S and Pinv, transposed, in f64
__host__ __device__ constexpr int ca_smem_bytes(int ke, int s, int blocks) {
  return 16 + 8 * (4 * (ke + 2) * NX + ke * NX * (4 * s + 3)
                   + 2 * (2 * s + 1) * (2 * s + 1) + 2 * (2 * s + 1) + 1)
         + blocks * 8 * 2 * CA_KNOT_STRIDE * ke;
}

// knot k's three blocks on the extended slab: the left halo's h rows, the
// shard's L rows, the right halo's h rows
__device__ inline const float* ext_block(const float* left, const float* loc,
                                         const float* right, int k, int h,
                                         int L) {
  if (k < h) return left + (size_t)k * 3 * NN;
  if (k < h + L) return loc + (size_t)(k - h) * 3 * NN;
  return right + (size_t)(k - h - L) * 3 * NN;
}

// entry (i, j) of band b of a knot's blocks: transposed in shared memory
// (kT: f64, at b NN + j NX + i) or row-major in global memory (f32)
template <bool kT>
__device__ inline double band_at(const std::conditional_t<kT, double, float>* M,
                                 int b, int i, int j) {
  return kT ? M[b * NN + j * NX + i] : M[b * NN + i * NX + j];
}

// sum_j M_b[i][j] x[j] in j order, x (NX, f64) 16-byte aligned: the row of
// the band and x loaded first, then the fma chain
template <bool kT>
__device__ inline double band_dot(const std::conditional_t<kT, double, float>* M,
                                  int b, int i, const double* x) {
  double mv[NX];
  double2 xv[NX / 2];
#pragma unroll
  for (int j = 0; j < NX; ++j) mv[j] = band_at<kT>(M, b, i, j);
#pragma unroll
  for (int jj = 0; jj < NX / 2; ++jj) xv[jj] = reinterpret_cast<const double2*>(x)[jj];
  double acc = 0.0;
#pragma unroll
  for (int jj = 0; jj < NX / 2; ++jj) {
    acc += mv[2 * jj] * xv[jj].x;
    acc += mv[2 * jj + 1] * xv[jj].y;
  }
  return acc;
}

// row i of the banded product at extended knot k (own knot kk, rows kk + 1
// of the halo-extended vector x; the rows start 16-byte aligned) with zero
// ends: (centre + left) + right in f64, each sum in the parent's order
template <bool kT>
__device__ inline double band_row(const std::conditional_t<kT, double, float>* M,
                                  const double* x, int kk, int i, int k, int Le) {
  const double* xr = x + kk * NX;
  const double c = band_dot<kT>(M, 1, i, xr + NX);
  const double l = k > 0 ? band_dot<kT>(M, 0, i, xr) : 0.0;
  const double r = k < Le - 1 ? band_dot<kT>(M, 2, i, xr + 2 * NX) : 0.0;
  return (c + l) + r;
}

// kBlocks: S and Pinv of the own knots in shared memory (else read from
// global memory); ke extended knots per CTA
template <bool kBlocks>
__global__ void __launch_bounds__(CA_MAX_THREADS, 1)
ca_basis_kernel(const float* __restrict__ p, const float* __restrict__ z,
                const float* __restrict__ r, const float* __restrict__ S,
                const float* __restrict__ Pinv, int sys_bstride,
                const float* __restrict__ SL, const float* __restrict__ SR,
                const float* __restrict__ PL, const float* __restrict__ PR,
                const float* __restrict__ fl, const float* __restrict__ fr,
                const double* __restrict__ scal, const int* __restrict__ iters,
                const int* __restrict__ done, double* __restrict__ Y,
                double* __restrict__ Yt, double* __restrict__ parts, int L,
                int s, int max_iter, int ke) {
  extern __shared__ __align__(16) double sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y, tid = threadIdx.x, nth = blockDim.x, nw = nth >> 5;
  if (done[b] != 0 || iters[b] >= max_iter) return;   // the same for all
  const int h = 2 * s + 1, m = 2 * s + 1, Le = L + 2 * h, zc = 2 * m + 1;
  const int n = L * NX, mm = m * m, np = 2 * mm + 2 * m + 1;
  p += (size_t)b * n;
  z += (size_t)b * n;
  r += (size_t)b * n;
  S += (size_t)b * sys_bstride;
  Pinv += (size_t)b * sys_bstride;
  SL += (size_t)b * h * 3 * NN;
  SR += (size_t)b * h * 3 * NN;
  PL += (size_t)b * h * 3 * NN;
  PR += (size_t)b * h * 3 * NN;
  fl += (size_t)b * 2 * h * NX;
  fr += (size_t)b * 2 * h * NX;
  Y += (size_t)b * m * n;
  Yt += (size_t)b * m * n;
  parts += (size_t)b * np;
  // this CTA's extended knots [k0, k0 + nk); its neighbours
  const int k0 = rank * ke, nk = max(0, min(ke, Le - k0));
  const bool has_left = nk > 0 && k0 > 0, has_right = nk > 0 && k0 + nk < Le;
  const int ve = (ke + 2) * NX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sh);     // phases t even, odd
  double* xv = sh + 2;             // V's current vector, rows: halo, own, halo
  double* tv = xv + ve;            // its S-image
  double* xw = tv + ve;            // W's
  double* tw = xw + ve;
  double* Z = tw + ve;             // own rows x [Y | Ytil | r]
  double* part = Z + ke * NX * zc; // the CTA's Gram partials
  double* St = part + np;          // kBlocks: S, Pinv of the own knots
  double* Pt = St + CA_KNOT_STRIDE * ke;

  if (tid == 0) {
    mbar_init(bar, nw);
    mbar_init(bar + 1, nw);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA's mbarriers initialised before the first st.async (waited
  // for below, after the loads)
  cluster_arrive();
  if (kBlocks) {
    // S and Pinv, transposed, in f64: 16-byte loads (a knot's 3 NN floats
    // are 3 NN / 4 of them, 147 at NX = 14; the wrapper checks the
    // alignment), CA_LOAD_BATCH of each a thread in flight, all loaded
    // before any is stored
    constexpr int Q = 3 * NN / 4;
    const int nq = nk * Q;
    for (int base = 0; base < nq; base += CA_LOAD_BATCH * nth) {
      float4 vs[CA_LOAD_BATCH], vp[CA_LOAD_BATCH];
#pragma unroll
      for (int u = 0; u < CA_LOAD_BATCH; ++u) {
        const int q = base + u * nth + tid;
        if (q < nq) {
          const int kk = q / Q;
          vs[u] = reinterpret_cast<const float4*>(
              ext_block(SL, S, SR, k0 + kk, h, L))[q - kk * Q];
          vp[u] = reinterpret_cast<const float4*>(
              ext_block(PL, Pinv, PR, k0 + kk, h, L))[q - kk * Q];
        }
      }
#pragma unroll
      for (int u = 0; u < CA_LOAD_BATCH; ++u) {
        const int q = base + u * nth + tid;
        if (q < nq) {
          const int kk = q / Q;
          const float ws[4] = {vs[u].x, vs[u].y, vs[u].z, vs[u].w};
          const float wp[4] = {vp[u].x, vp[u].y, vp[u].z, vp[u].w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int f = 4 * (q - kk * Q) + a;
            const int band = f / NN, ij = f - band * NN, i = ij / NX, j = ij - i * NX;
            const int dst = kk * CA_KNOT_STRIDE + band * NN + j * NX + i;
            St[dst] = ws[a];
            Pt[dst] = wp[a];
          }
        }
      }
    }
  }
  // p and z over the own knots and the halo rows on each side (the input of
  // the first product); r on the own local rows into Z's last column
  for (int e = tid; e < (nk + 2) * NX; e += nth) {
    const int g = (k0 - 1) * NX + e;   // extended row of halo-extended row e
    double a = 0.0, w = 0.0;
    if (nk > 0 && g >= 0 && g < Le * NX) {
      const int kx = g / NX, c = g - kx * NX;
      if (kx < h) {
        a = fl[kx * NX + c];
        w = fl[(h + kx) * NX + c];
      } else if (kx < h + L) {
        a = p[(kx - h) * NX + c];
        w = z[(kx - h) * NX + c];
      } else {
        a = fr[(kx - h - L) * NX + c];
        w = fr[(h + kx - h - L) * NX + c];
      }
      if (e >= NX && e < (nk + 1) * NX && kx >= h && kx < h + L)
        Z[(e - NX) * zc + 2 * m] = r[(kx - h) * NX + c];
    }
    xv[e] = a;
    xw[e] = w;
  }
  __syncthreads();
  const double ginv = 1.0 / scal[2 * b + 1];
  // this thread's row i of own knot kk (extended knot k), and its chains:
  // V's and W's (one thread a row), or V's on the first ke NX threads and
  // W's on the next (split, where the CTA has two threads a row).  The edge
  // knots' rows push their products into the neighbours' halo rows (the
  // left neighbour's last, the right one's first: both hold ke knots).
  const int rows = ke * NX;
  const bool split = nth >= 2 * rows;
  const int c_lo = split ? tid / rows : 0, c_hi = split ? c_lo + 1 : 2;
  const int rt = split ? tid - c_lo * rows : tid;
  const int kk = rt / NX, i = rt - kk * NX, k = k0 + kk;
  const bool own = rt < nk * NX && c_lo < 2;
  const bool loc = own && k >= h && k < h + L;
  const bool push_l = own && kk == 0 && has_left;
  const bool push_r = own && kk == nk - 1 && has_right;
  const int o = (k - h) * NX + i;          // the local row, where loc
  const int row = (kk + 1) * NX + i;       // the halo-extended row
  using Blk = std::conditional_t<kBlocks, double, float>;
  const Blk* Mk;
  const Blk* Pk;
  if constexpr (kBlocks) {
    Mk = St + kk * CA_KNOT_STRIDE;
    Pk = Pt + kk * CA_KNOT_STRIDE;
  } else {
    Mk = ext_block(SL, S, SR, own ? k : 0, h, L);
    Pk = ext_block(PL, Pinv, PR, own ? k : 0, h, L);
  }
  cluster_wait();
  // phase t: V's t-th product (S at even t, Pinv at odd t; 2s+1 of them),
  // W's alongside while it has one (2s-1); phase t's rows are read by phase
  // t + 1, so the edges push V's rows up to t = 2s-1 and W's up to 2s-3
  for (int t = 0; t <= 2 * s; ++t) {
    const bool odd = t & 1;
    const int j = t >> 1;
    for (int c = c_lo; c < c_hi && own; ++c) {
      if (c == 1 && t > 2 * s - 2) break;
      const double* in = c == 0 ? (odd ? tv : xv) : (odd ? tw : xw);
      double* out = c == 0 ? (odd ? xv : tv) : (odd ? xw : tw);
      double y = band_row<kBlocks>(odd ? Pk : Mk, in, kk, i, k, Le);
      if (odd) y *= ginv;
      out[row] = y;
      const int col = c == 0 ? j : s + 1 + j;   // the chain's column of Y
      if (!odd && loc) {
        double* zr = Z + (kk * NX + i) * zc;
        Y[col * n + o] = zr[col] = in[row];
        Yt[col * n + o] = zr[m + col] = y;
      }
      if (t < 2 * s - (c == 0 ? 0 : 2)) {
        for (int side = 0; side < 2; ++side) {
          if (!(side == 0 ? push_l : push_r)) continue;
          const int nb = side == 0 ? rank - 1 : rank + 1;
          const int hrow = side == 0 ? (ke + 1) * NX + i : i;
          st_async64(cluster_u32(out + hrow, nb), y,
                     cluster_u32(bar + (t & 1), nb));
        }
      }
    }
    if (t == 2 * s) break;
    // the halo rows of phase t + 1's input: from each neighbour, V's row
    // and, while W's is pushed, W's
    __syncwarp();
    if ((tid & 31) == 0) {
      if (tid == 0)
        mbar_arrive_tx(bar + (t & 1), ((has_left ? 1 : 0) + (has_right ? 1 : 0)) *
                                          (t <= 2 * s - 3 ? 2 : 1) * NX * 8);
      else
        mbar_arrive(bar + (t & 1));
    }
    mbar_wait(bar + (t & 1), (t >> 1) & 1);
  }
  __syncthreads();
  // the Gram partials: part d over the own local rows
  const int r_lo = NX * max(0, min(nk, h - k0));
  const int r_hi = NX * max(0, min(nk, h + L - k0));
  for (int d = tid; d < np; d += nth) {
    int u, v;
    if (d < mm) {
      u = d / m;
      v = m + d % m;
    } else if (d < mm + m) {
      u = d - mm;
      v = 2 * m;
    } else if (d < 2 * mm + m) {
      const int e = d - mm - m;
      u = m + e / m;
      v = m + e % m;
    } else if (d < 2 * mm + 2 * m) {
      u = m + d - 2 * mm - m;
      v = 2 * m;
    } else {
      u = v = 2 * m;
    }
    // rows r_lo + 4q + a into accumulator a, the tail into the first
    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
    int rr = r_lo;
    for (; rr + 3 < r_hi; rr += 4) {
      a0 += Z[rr * zc + u] * Z[rr * zc + v];
      a1 += Z[(rr + 1) * zc + u] * Z[(rr + 1) * zc + v];
      a2 += Z[(rr + 2) * zc + u] * Z[(rr + 2) * zc + v];
      a3 += Z[(rr + 3) * zc + u] * Z[(rr + 3) * zc + v];
    }
    for (; rr < r_hi; ++rr) a0 += Z[rr * zc + u] * Z[rr * zc + v];
    part[d] = (a0 + a1) + (a2 + a3);
  }
  // every CTA's partials, summed by rank 0 in rank order; the second
  // barrier keeps every CTA resident until rank 0 has read them
  cluster_arrive();
  cluster_wait();
  if (rank == 0) {
    for (int d = tid; d < np; d += nth) {
      // every rank's partial in flight at once, then the sum in rank order
      double v[CA_MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < CA_MAX_CLUSTER; ++q)
        v[q] = q < C ? cluster.map_shared_rank(part, q)[d] : 0.0;
      double tot = v[0];
#pragma unroll
      for (int q = 1; q < CA_MAX_CLUSTER; ++q)
        if (q < C) tot += v[q];
      parts[d] = tot;
    }
  }
  cluster_arrive();
  cluster_wait();
}

// The coefficient step on one shard's rows [lo, lo + R) (the CTA of rank q
// of the shard's cluster, lo = q R): warp 0 runs the s coefficient
// iterations; the other warps load their first row's Y and Ytil meanwhile,
// and rank 0's warp 1 forms the next scale; then every row thread recovers
// its rows.  kS = s (m = 2s+1 coefficients in registers).
template <int kS>
__global__ void __launch_bounds__(COEF_MAX_THREADS, 1)
ca_coeff_kernel(float* __restrict__ x, float* __restrict__ r,
                float* __restrict__ z, float* __restrict__ p,
                const double* __restrict__ Y, const double* __restrict__ Yt,
                const double* __restrict__ tot, int tot_bstride,
                double* __restrict__ scal, int* __restrict__ iters,
                int* __restrict__ done, float* __restrict__ pkt, int L, int s,
                int R, int max_iter, const float* __restrict__ tol_p,
                int rnorm) {
  constexpr int m = 2 * kS + 1, mm = m * m, h = m;
  __shared__ double coef[3 * m];      // e, c, a
  __shared__ double fin[2];           // eta, the next scale g
  __shared__ int fin_i[2];            // iters, done
  const int b = blockIdx.y, tid = threadIdx.x, nth = blockDim.x;
  if (done[b] != 0 || iters[b] >= max_iter) return;   // the same for all
  const double eta0 = scal[2 * b], g = scal[2 * b + 1];
  const int it0 = iters[b];
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int n = L * NX;
  x += (size_t)b * n;
  r += (size_t)b * n;
  z += (size_t)b * n;
  p += (size_t)b * n;
  Y += (size_t)b * m * n;
  Yt += (size_t)b * m * n;
  tot += (size_t)b * tot_bstride;
  pkt += (size_t)b * 4 * h * NX;
  const int lo = rank * R, hi = min(n, lo + R), t = tid - 32, nrt = nth - 32;
  // a row thread's first row, loaded while warp 0 iterates
  double y0[m], yt0[m];
  float x0 = 0.f, r0 = 0.f;
  if (tid < 32) {
    // the s iterations: lane q < m holds row q of G and F, every lane b, f
    // and the coefficient vectors (each forms the same values in the same
    // order); row q's products go to every lane by shuffles
    const int q = min(tid, m - 1);
    double Gr[m], Fr[m], bv[m], fv[m];
#pragma unroll
    for (int l = 0; l < m; ++l) {
      Gr[l] = tot[q * m + l];
      Fr[l] = tot[mm + m + q * m + l];
      bv[l] = tot[mm + l];
      fv[l] = tot[2 * mm + m + l];
    }
    const double rr0 = tot[2 * mm + 2 * m];
    const float tol = *tol_p, tol2 = tol * tol;
    double eta = eta0;
    int it = it0;
    bool dn = false;
    double ce[m], ca[m], cc[m];
#pragma unroll
    for (int l = 0; l < m; ++l) {
      ce[l] = 0.0;
      ca[l] = l == 0 ? 1.0 : 0.0;
      cc[l] = l == kS + 1 ? 1.0 : 0.0;
    }
    const unsigned full = 0xffffffffu;
#pragma unroll 1
    for (int step = 0; step < kS; ++step) {
      const bool act = !dn && it < max_iter;
      double v = 0.0;
#pragma unroll
      for (int l = 0; l < m; ++l) v += Gr[l] * ca[l];
      double denom = 0.0;
#pragma unroll
      for (int l = 0; l < m; ++l) denom += ca[l] * __shfl_sync(full, v, l);
      const double alpha = eta / (denom == 0.0 ? 1.0 : denom);
      double en[m], cn[m];
#pragma unroll
      for (int l = 0; l < m; ++l) {
        // (g T a)_l = g a_{l-1} inside either chain, else 0
        const bool shifted = (l >= 1 && l <= kS) || (l >= kS + 2 && l <= 2 * kS);
        en[l] = ce[l] + alpha * ca[l];
        cn[l] = cc[l] - alpha * (shifted ? g * ca[l > 0 ? l - 1 : 0] : 0.0);
      }
      double gc = 0.0, fe = 0.0;
#pragma unroll
      for (int l = 0; l < m; ++l) {
        gc += Gr[l] * cn[l];
        fe += Fr[l] * en[l];
      }
      double bc = 0.0, egc = 0.0, f_e = 0.0, efe = 0.0;
#pragma unroll
      for (int l = 0; l < m; ++l) {
        bc += bv[l] * cn[l];
        egc += en[l] * __shfl_sync(full, gc, l);
        f_e += fv[l] * en[l];
        efe += en[l] * __shfl_sync(full, fe, l);
      }
      const double eta_n = bc - egc;
      const double rr_n = (rr0 - 2.0 * f_e) + efe;
      const double beta = eta_n / (eta == 0.0 ? 1.0 : eta);
      const bool done_n = rnorm ? rr_n < (double)tol2 : fabs(eta_n) < (double)tol;
      if (act) {
#pragma unroll
        for (int l = 0; l < m; ++l) {
          ca[l] = cn[l] + beta * ca[l];
          ce[l] = en[l];
          cc[l] = cn[l];
        }
        eta = eta_n;
      }
      it += act ? 1 : 0;
      dn = dn || (act && done_n);
    }
    if (tid == 0) {
#pragma unroll
      for (int l = 0; l < m; ++l) {
        coef[l] = ce[l];
        coef[m + l] = cc[l];
        coef[2 * m + l] = ca[l];
      }
      fin[0] = eta;
      fin_i[0] = it;
      fin_i[1] = dn ? 1 : 0;
    }
  } else {
    if (lo + t < hi) {
#pragma unroll
      for (int l = 0; l < m; ++l) {
        y0[l] = Y[l * n + lo + t];
        yt0[l] = Yt[l * n + lo + t];
      }
      x0 = x[lo + t];
      r0 = r[lo + t];
    }
    if (rank == 0 && t == 0) {
      // the next scale g (|G[s,s]| / |G[0,0]|)^(1/2s), clipped
      double den = fabs(tot[0]);
      den = den < DBL_MIN ? DBL_MIN : den;            // NaN stays NaN
      double gn = g * pow(fabs(tot[s * m + s]) / den, 1.0 / (2 * s));
      gn = gn < 1e-6 ? 1e-6 : (gn > 1e6 ? 1e6 : gn);
      fin[1] = isfinite(gn) ? gn : g;
    }
  }
  __syncthreads();
  // every CTA's reads of scal, iters and done happen before rank 0 writes
  // them: it waits for this arrival at the end
  cluster_arrive();
  // the recovery, and the packets: [last h rows, first h rows] x [p, z]
  if (tid >= 32) {
    for (int i = lo + t, first = 1; i < hi; i += nrt, first = 0) {
      double ye = 0.0, yte = 0.0, yc = 0.0, ya = 0.0;
#pragma unroll
      for (int l = 0; l < m; ++l) {
        const double y = first ? y0[l] : Y[l * n + i];
        const double yt = first ? yt0[l] : Yt[l * n + i];
        ye += coef[l] * y;
        yte += coef[l] * yt;
        yc += coef[m + l] * y;
        ya += coef[2 * m + l] * y;
      }
      const float xi = static_cast<float>((first ? x0 : x[i]) + ye);
      const float ri = static_cast<float>((first ? r0 : r[i]) - yte);
      const float zi = static_cast<float>(yc), pi = static_cast<float>(ya);
      x[i] = xi;
      r[i] = ri;
      z[i] = zi;
      p[i] = pi;
      const int k = i / NX, c = i - k * NX;
      if (k >= L - h) {
        pkt[(k - (L - h)) * NX + c] = pi;
        pkt[(h + k - (L - h)) * NX + c] = zi;
      }
      if (k < h) {
        pkt[(2 * h + k) * NX + c] = pi;
        pkt[(3 * h + k) * NX + c] = zi;
      }
    }
  }
  __syncwarp();
  cluster_wait();
  if (rank == 0 && tid == 0) {
    scal[2 * b] = fin[0];
    scal[2 * b + 1] = fin[1];
    iters[b] = fin_i[0];
    done[b] = fin_i[1];
  }
}

template <int kS>
int launch_coeff(int cluster, int threads, cudaStream_t stream, float* x,
                 float* r, float* z, float* p, const double* Y,
                 const double* Yt, const double* tot, int tot_bstride,
                 double* scal, int* iters, int* done, float* pkt, int L, int R,
                 int n_shard, int max_iter, const float* tol, int rnorm) {
  cudaError_t err = cudaSuccess;
  if (cluster > 8)
    err = cudaFuncSetAttribute(ca_coeff_kernel<kS>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(cluster, n_shard, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ca_coeff_kernel<kS>, x, r, z, p, Y, Yt, tot,
                           tot_bstride, scal, iters, done, pkt, L, kS, R,
                           max_iter, tol, rnorm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_shard shards, one cluster of `cluster` CTAs each, ke extended knots and
// `threads` threads per CTA, smem bytes of dynamic shared memory (at least
// ca_smem_bytes(ke, s, blocks)), the own knots' S and Pinv in shared memory
// where `blocks` (ops/pcg_ca_cuda.py::ca_cluster_plan): shard b builds its
// bases from its p, z, r ((L, NX) slabs), its system S / Pinv + b
// sys_bstride (L knots of 3 NX x NX blocks, read in place), the
// neighbours' h rows SL, SR, PL, PR (h, 3, NX, NX) and packets fl, fr (2,
// h, NX), the scale scal[2b + 1] (f64), and writes Y, Yt (m, L, NX) and its
// parts (2m^2 + 2m + 1), in f64.  A shape the plan does not describe is
// refused (cudaErrorInvalidValue); one the card cannot hold fails the launch.
extern "C" int ca_basis_launch(const float* p, const float* z, const float* r,
                               const float* S, const float* Pinv,
                               int sys_bstride, const float* SL,
                               const float* SR, const float* PL,
                               const float* PR, const float* fl,
                               const float* fr, const double* scal,
                               const int* iters, const int* done, double* Y,
                               double* Yt, double* parts, int L, int s,
                               int n_shard, int max_iter, int cluster, int ke,
                               int blocks, int threads, int smem,
                               void* stream) {
  const int Le = L + 2 * (2 * s + 1);
  if (s < 1 || s > MAX_S || cluster < 1 || cluster > CA_MAX_CLUSTER ||
      (cluster & (cluster - 1)) || ke < 1 || cluster * ke < Le ||
      threads < NX * ke || threads > CA_MAX_THREADS || threads % 32 != 0 ||
      smem < ca_smem_bytes(ke, s, blocks ? 1 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = blocks ? ca_basis_kernel<true> : ca_basis_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
  err = cudaLaunchKernelEx(&cfg, kernel, p, z, r, S, Pinv, sys_bstride, SL, SR,
                           PL, PR, fl, fr, scal, iters, done, Y, Yt, parts, L,
                           s, max_iter, ke);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// n_shard shards, one cluster of `cluster` CTAs each, R rows and `threads`
// threads per CTA (ops/pcg_ca_cuda.py::coeff_plan): shard b advances x, r,
// z, p (L, NX) from its Y, Yt (m, L, NX) and the summed parts tot + b
// tot_bstride (f64), updates its scal (eta, g; f64), iters[b], done[b], and
// writes its packets pkt (2, 2, h, NX).  A shape the plan does not describe
// is refused (cudaErrorInvalidValue).
extern "C" int ca_coeff_launch(float* x, float* r, float* z, float* p,
                               const double* Y, const double* Yt,
                               const double* tot, int tot_bstride, double* scal,
                               int* iters, int* done, float* pkt, int L, int s,
                               int n_shard, int cluster, int R, int threads,
                               int max_iter, const float* tol, int rnorm,
                               void* stream) {
  if (s < 1 || s > MAX_S || cluster < 1 || cluster > COEF_MAX_CLUSTER ||
      (cluster & (cluster - 1)) || R < 1 || cluster * R < L * NX ||
      threads < 64 || threads > COEF_MAX_THREADS || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define COEF_CASE(k)                                                         \
  case k:                                                                    \
    return launch_coeff<k>(cluster, threads, st, x, r, z, p, Y, Yt, tot,     \
                           tot_bstride, scal, iters, done, pkt, L, R, n_shard, \
                           max_iter, tol, rnorm);
  switch (s) {
    COEF_CASE(1)
    COEF_CASE(2)
    COEF_CASE(3)
    COEF_CASE(4)
    COEF_CASE(5)
    COEF_CASE(6)
    COEF_CASE(7)
    COEF_CASE(8)
  }
#undef COEF_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
