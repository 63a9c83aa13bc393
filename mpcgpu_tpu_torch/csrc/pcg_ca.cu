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
// Pinv (2 x 3 x 14^2 x (L + 2h) floats, 386 KB at L = 64, s = 4) once per
// product from L2, 16 dependent products separated by block barriers, then
// 181 dot products over the shard's L x 14 rows; one block per shard keeps
// the two chains' working vectors in shared memory (each product reads its
// blocks once for both chains) and gives each dot product a warp.  The
// coefficient step is a few hundred dependent flops in one warp, then an
// m-term combination per row.
#include <cfloat>
#include <cmath>

#include "common.cuh"

using namespace mpc;

namespace {

constexpr int NN = NX * NX;
constexpr int MAX_S = 8;
constexpr int MAX_M = 2 * MAX_S + 1;

// knot k's three blocks on the extended slab: the left halo's h rows, the
// shard's L rows, the right halo's h rows
__device__ inline const float* ext_block(const float* left, const float* loc,
                                         const float* right, int k, int h,
                                         int L) {
  if (k < h) return left + (size_t)k * 3 * NN;
  if (k < h + L) return loc + (size_t)(k - h) * 3 * NN;
  return right + (size_t)(k - h - L) * 3 * NN;
}

// row c of the banded product at extended knot k with zero ends, for xa and
// (two) xb, the blocks read once: (centre + left) + right, in f64
__device__ inline void band_ext(const float* M3, const double* xa,
                                const double* xb, bool two, int k, int Le,
                                int c, double* ya, double* yb) {
  double ca = 0.0, la = 0.0, ra = 0.0, cb = 0.0, lb = 0.0, rb = 0.0;
  const float* m1 = M3 + NN + c * NX;
  for (int j = 0; j < NX; ++j) {
    ca += m1[j] * xa[k * NX + j];
    if (two) cb += m1[j] * xb[k * NX + j];
  }
  if (k > 0) {
    const float* m0 = M3 + c * NX;
    for (int j = 0; j < NX; ++j) {
      la += m0[j] * xa[(k - 1) * NX + j];
      if (two) lb += m0[j] * xb[(k - 1) * NX + j];
    }
  }
  if (k < Le - 1) {
    const float* m2 = M3 + 2 * NN + c * NX;
    for (int j = 0; j < NX; ++j) {
      ra += m2[j] * xa[(k + 1) * NX + j];
      if (two) rb += m2[j] * xb[(k + 1) * NX + j];
    }
  }
  *ya = (ca + la) + ra;
  *yb = (cb + lb) + rb;
}

__global__ void __launch_bounds__(1024)
ca_basis_kernel(const float* __restrict__ p, const float* __restrict__ z,
                const float* __restrict__ r, const float* __restrict__ S,
                const float* __restrict__ Pinv, int sys_bstride,
                const float* __restrict__ SL, const float* __restrict__ SR,
                const float* __restrict__ PL, const float* __restrict__ PR,
                const float* __restrict__ fl, const float* __restrict__ fr,
                const double* __restrict__ scal, const int* __restrict__ iters,
                const int* __restrict__ done, double* Y, double* Yt,
                double* __restrict__ parts, int L, int s, int max_iter) {
  extern __shared__ double sh[];
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  if (done[b] != 0 || iters[b] >= max_iter) return;   // the same for all
  const int h = 2 * s + 1, m = 2 * s + 1, Le = L + 2 * h;
  const int n = L * NX, ne = Le * NX, mm = m * m, np = 2 * mm + 2 * m + 1;
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
  const double ginv = 1.0 / scal[2 * b + 1];

  // the chains' working vectors on the extended slab: V's current vector
  // and its S-image, W's
  double* xv = sh;
  double* tv = sh + ne;
  double* xw = sh + 2 * ne;
  double* tw = sh + 3 * ne;
  for (int i = tid; i < ne; i += nth) {
    const int k = i / NX, c = i - k * NX;
    if (k < h) {
      xv[i] = fl[k * NX + c];
      xw[i] = fl[(h + k) * NX + c];
    } else if (k < h + L) {
      xv[i] = p[(k - h) * NX + c];
      xw[i] = z[(k - h) * NX + c];
    } else {
      const int kk = k - h - L;
      xv[i] = fr[kk * NX + c];
      xw[i] = fr[(h + kk) * NX + c];
    }
  }
  __syncthreads();
  // phase t: V's t-th product (S at even t, Pinv at odd t; 2s+1 of them),
  // W's alongside while it has one (2s-1)
  for (int t = 0; t <= 2 * s; ++t) {
    const bool odd = t & 1, two = t <= 2 * s - 2;
    const int j = t >> 1;
    for (int i = tid; i < ne; i += nth) {
      const int k = i / NX, c = i - k * NX;
      double yv, yw;
      if (!odd) {
        band_ext(ext_block(SL, S, SR, k, h, L), xv, xw, two, k, Le, c, &yv, &yw);
        tv[i] = yv;
        if (two) tw[i] = yw;
        if (k >= h && k < h + L) {
          const int o = (k - h) * NX + c;
          Y[j * n + o] = xv[i];
          Yt[j * n + o] = yv;
          if (two) {
            Y[(s + 1 + j) * n + o] = xw[i];
            Yt[(s + 1 + j) * n + o] = yw;
          }
        }
      } else {
        band_ext(ext_block(PL, Pinv, PR, k, h, L), tv, tw, two, k, Le, c, &yv, &yw);
        xv[i] = yv * ginv;
        if (two) xw[i] = yw * ginv;
      }
    }
    __syncthreads();
  }
  // the Gram parts: one warp per part, its lanes over the rows in a fixed
  // order, then a shuffle tree; a null factor stands for r
  const int lane = tid & 31, nw = nth >> 5;
  for (int d = tid >> 5; d < np; d += nw) {
    const double *u = nullptr, *v = nullptr;
    if (d < mm) {
      u = Y + (d / m) * n;
      v = Yt + (d % m) * n;
    } else if (d < mm + m) {
      u = Y + (d - mm) * n;
    } else if (d < 2 * mm + m) {
      const int e = d - mm - m;
      u = Yt + (e / m) * n;
      v = Yt + (e % m) * n;
    } else if (d < 2 * mm + 2 * m) {
      u = Yt + (d - 2 * mm - m) * n;
    }
    double acc = 0.0;
    for (int i = lane; i < n; i += 32) {
      const double ri = r[i];
      acc += (u != nullptr ? u[i] : ri) * (v != nullptr ? v[i] : ri);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) parts[d] = acc;
  }
}

__global__ void __launch_bounds__(256)
ca_coeff_kernel(float* __restrict__ x, float* __restrict__ r,
                float* __restrict__ z, float* __restrict__ p,
                const double* __restrict__ Y, const double* __restrict__ Yt,
                const double* __restrict__ tot, int tot_bstride,
                double* __restrict__ scal, int* __restrict__ iters,
                int* __restrict__ done, float* __restrict__ pkt, int L, int s,
                int max_iter, const float* __restrict__ tol_p, int rnorm) {
  __shared__ double G[MAX_M * MAX_M], F[MAX_M * MAX_M], bv[MAX_M], fv[MAX_M];
  __shared__ double ce[MAX_M], ca[MAX_M], cc[MAX_M], en[MAX_M], cn[MAX_M];
  __shared__ double v1[MAX_M], v2[MAX_M];
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  if (done[b] != 0 || iters[b] >= max_iter) return;   // the same for all
  const int m = 2 * s + 1, h = m, mm = m * m, n = L * NX;
  x += (size_t)b * n;
  r += (size_t)b * n;
  z += (size_t)b * n;
  p += (size_t)b * n;
  Y += (size_t)b * m * n;
  Yt += (size_t)b * m * n;
  tot += (size_t)b * tot_bstride;
  scal += 2 * b;
  pkt += (size_t)b * 4 * h * NX;
  for (int e = tid; e < mm; e += nth) {
    G[e] = tot[e];
    F[e] = tot[mm + m + e];
  }
  if (tid < m) {
    bv[tid] = tot[mm + tid];
    fv[tid] = tot[2 * mm + m + tid];
  }
  __syncthreads();
  if (tid < 32) {
    // the s iterations: lane q < m owns row q of each product, every lane
    // forms the same dot products in the same order
    const int q = tid;
    const double rr0 = tot[2 * mm + 2 * m], g = scal[1];
    const float tol = *tol_p, tol2 = tol * tol;
    double eta = scal[0];
    int it = iters[b];
    bool dn = false;
    if (q < m) {
      ce[q] = 0.0;
      ca[q] = q == 0 ? 1.0 : 0.0;
      cc[q] = q == s + 1 ? 1.0 : 0.0;
    }
    __syncwarp();
    for (int step = 0; step < s; ++step) {
      const bool act = !dn && it < max_iter;
      if (q < m) {
        double acc = 0.0;
        for (int l = 0; l < m; ++l) acc += G[q * m + l] * ca[l];
        v1[q] = acc;
      }
      __syncwarp();
      double denom = 0.0;
      for (int l = 0; l < m; ++l) denom += ca[l] * v1[l];
      const double alpha = eta / (denom == 0.0 ? 1.0 : denom);
      if (q < m) {
        // (g T a)_q = g a_{q-1} inside either chain, else 0
        const bool shifted = (q >= 1 && q <= s) || (q >= s + 2 && q <= 2 * s);
        en[q] = ce[q] + alpha * ca[q];
        cn[q] = cc[q] - alpha * (shifted ? g * ca[q - 1] : 0.0);
      }
      __syncwarp();
      if (q < m) {
        double gc = 0.0, fe = 0.0;
        for (int l = 0; l < m; ++l) {
          gc += G[q * m + l] * cn[l];
          fe += F[q * m + l] * en[l];
        }
        v1[q] = gc;
        v2[q] = fe;
      }
      __syncwarp();
      double bc = 0.0, egc = 0.0, f_e = 0.0, efe = 0.0;
      for (int l = 0; l < m; ++l) {
        bc += bv[l] * cn[l];
        egc += en[l] * v1[l];
        f_e += fv[l] * en[l];
        efe += en[l] * v2[l];
      }
      const double eta_n = bc - egc;
      const double rr_n = (rr0 - 2.0 * f_e) + efe;
      const double beta = eta_n / (eta == 0.0 ? 1.0 : eta);
      const bool done_n = rnorm ? rr_n < (double)tol2 : fabs(eta_n) < (double)tol;
      __syncwarp();
      if (act && q < m) {
        ca[q] = cn[q] + beta * ca[q];
        ce[q] = en[q];
        cc[q] = cn[q];
      }
      if (act) eta = eta_n;
      it += act ? 1 : 0;
      dn = dn || (act && done_n);
      __syncwarp();
    }
    if (q == 0) {
      double den = fabs(G[0]);
      den = den < DBL_MIN ? DBL_MIN : den;            // NaN stays NaN
      double gn = g * pow(fabs(G[s * m + s]) / den, 1.0 / (2 * s));
      gn = gn < 1e-6 ? 1e-6 : (gn > 1e6 ? 1e6 : gn);
      scal[0] = eta;
      scal[1] = isfinite(gn) ? gn : g;
      iters[b] = it;
      done[b] = dn ? 1 : 0;
    }
  }
  __syncthreads();
  // the recovery, and the packets: [last h rows, first h rows] x [p, z]
  for (int i = tid; i < n; i += nth) {
    double ye = 0.0, yte = 0.0, yc = 0.0, ya = 0.0;
    for (int l = 0; l < m; ++l) {
      const double y = Y[l * n + i];
      ye += ce[l] * y;
      yte += ce[l] * Yt[l * n + i];
      yc += cc[l] * y;
      ya += ca[l] * y;
    }
    x[i] = static_cast<float>(x[i] + ye);
    r[i] = static_cast<float>(r[i] - yte);
    z[i] = static_cast<float>(yc);
    p[i] = static_cast<float>(ya);
    const int k = i / NX, c = i - k * NX;
    if (k >= L - h) {
      pkt[(k - (L - h)) * NX + c] = p[i];
      pkt[(h + k - (L - h)) * NX + c] = z[i];
    }
    if (k < h) {
      pkt[(2 * h + k) * NX + c] = p[i];
      pkt[(3 * h + k) * NX + c] = z[i];
    }
  }
}

}  // namespace

// n_shard shards, one block each: shard b builds its bases from its p, z, r
// ((L, NX) slabs), its system S / Pinv + b sys_bstride (L knots of 3 NX x NX
// blocks, read in place), the neighbours' h rows SL, SR, PL, PR (h, 3, NX,
// NX) and packets fl, fr (2, h, NX), the scale scal[2b + 1] (f64), and
// writes Y, Yt (m, L, NX) and its parts (2m^2 + 2m + 1), in f64
extern "C" int ca_basis_launch(const float* p, const float* z, const float* r,
                               const float* S, const float* Pinv,
                               int sys_bstride, const float* SL,
                               const float* SR, const float* PL,
                               const float* PR, const float* fl,
                               const float* fr, const double* scal,
                               const int* iters, const int* done, double* Y,
                               double* Yt, double* parts, int L, int s,
                               int n_shard, int max_iter, void* stream) {
  if (s < 1 || s > MAX_S) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)4 * (L + 2 * (2 * s + 1)) * NX * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      ca_basis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ca_basis_kernel<<<n_shard, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
      p, z, r, S, Pinv, sys_bstride, SL, SR, PL, PR, fl, fr, scal, iters, done,
      Y, Yt, parts, L, s, max_iter);
  return static_cast<int>(cudaGetLastError());
}

// n_shard shards, one block each: shard b advances x, r, z, p (L, NX) from its
// Y, Yt (m, L, NX) and the summed parts tot + b tot_bstride (f64), updates
// its scal (eta, g; f64), iters[b], done[b], and writes its packets pkt
// (2, 2, h, NX)
extern "C" int ca_coeff_launch(float* x, float* r, float* z, float* p,
                               const double* Y, const double* Yt,
                               const double* tot, int tot_bstride, double* scal,
                               int* iters, int* done, float* pkt, int L, int s,
                               int n_shard, int max_iter, const float* tol,
                               int rnorm, void* stream) {
  if (s < 1 || s > MAX_S) return static_cast<int>(cudaErrorInvalidValue);
  ca_coeff_kernel<<<n_shard, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, r, z, p, Y, Yt, tot, tot_bstride, scal, iters, done, pkt, L, s,
      max_iter, tol, rnorm);
  return static_cast<int>(cudaGetLastError());
}
