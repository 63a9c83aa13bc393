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
// What bounds it on an H100: like K2's iteration, latency.  Each step reads
// the shard's S and Pinv (2 x 3 x 14 x 14 x L floats, 301 KB at L = 64) and
// does 2 x 3 x 14^2 x 2 FLOP per knot, then three block reductions; one
// block per shard keeps the vectors in shared memory between the two
// banded products and streams S and Pinv from L2, as K2 does.
#include "common.cuh"

using namespace mpc;

namespace {

constexpr int NN = NX * NX;

// Row c of the banded product at knot k, M3 the knot's three blocks (k-1,
// k, k+1) and xe its row k-1 (rows k-1, k, k+1 follow): (centre + left) +
// right, the order of K2's btd_row.
__device__ inline float band_row(const float* __restrict__ M3, const float* xe,
                                 int c) {
  float cc = 0.f, l = 0.f, r = 0.f;
  for (int j = 0; j < NX; ++j) cc += M3[NN + c * NX + j] * xe[NX + j];
  for (int j = 0; j < NX; ++j) l += M3[c * NX + j] * xe[j];
  for (int j = 0; j < NX; ++j) r += M3[2 * NN + c * NX + j] * xe[2 * NX + j];
  return (cc + l) + r;
}

__global__ void __launch_bounds__(1024)
pcg_slab_kernel(float* __restrict__ x, float* __restrict__ r,
                float* __restrict__ p, float* __restrict__ s,
                float* __restrict__ u, float* __restrict__ w,
                const float* __restrict__ S, const float* __restrict__ Pinv,
                int sys_bstride, const float* __restrict__ flp,
                const float* __restrict__ frp, const float* __restrict__ PinvL,
                const float* __restrict__ PinvR, const float* __restrict__ tot,
                int tot_bstride, float* __restrict__ scal,
                int* __restrict__ iters, float* __restrict__ dots,
                float* __restrict__ pkt, int L, int max_iter,
                const float* __restrict__ tol_p, int rnorm, int init) {
  extern __shared__ float sh[];
  __shared__ float red[33];
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int n = L * NX;
  // shard blockIdx.x: its rows, system, packets and scalars
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
  PinvL += (size_t)b * 3 * NN;
  PinvR += (size_t)b * 3 * NN;
  tot += (size_t)b * tot_bstride;
  scal += (size_t)b * 2;
  dots += (size_t)b * 3;
  pkt += (size_t)b * 12 * NX;

  float alpha = 0.f, beta = 0.f, eta = 0.f;
  int it = 0;
  if (!init) {
    eta = tot[0];
    const float d = tot[1], rr = tot[2], tol = *tol_p;
    const bool done = rnorm ? rr < tol * tol : fabsf(eta) < tol;
    it = iters[b];
    if (done || it >= max_iter) return;     // the same for every thread
    if (it == 0) {
      alpha = eta / d;
    } else {
      beta = eta / scal[0];
      alpha = eta / (d - beta * eta / scal[1]);
    }
  }

  float* re = sh;                  // r rows -2 .. L+1 (row k at (k + 2) NX)
  float* ue = sh + (L + 4) * NX;   // u rows -1 .. L   (row k at (k + 1) NX)
  for (int i = tid; i < n; i += nth) {
    const float pi = u[i] + beta * p[i];
    const float si = w[i] + beta * s[i];
    x[i] += alpha * pi;
    const float ri = r[i] - alpha * si;
    p[i] = pi;
    s[i] = si;
    r[i] = ri;
    re[2 * NX + i] = ri;
  }
  // the neighbours' rows -2, -1 and L, L+1 after the same update
  if (tid < 4 * NX) {
    const int row = tid / NX, c = tid - row * NX, j = row & 1;
    const float* pk = row < 2 ? flp : frp;
    re[(row < 2 ? j : L + 2 + j) * NX + c] =
        pk[j * NX + c] - alpha * (pk[(2 + j) * NX + c] + beta * pk[(4 + j) * NX + c]);
  }
  __syncthreads();
  for (int i = tid; i < n; i += nth) {
    const int k = i / NX, c = i - k * NX;
    ue[NX + i] = band_row(Pinv + (size_t)k * 3 * NN, re + (k + 1) * NX, c);
  }
  // the off-slab rows u_{-1}, u_L from the neighbours' boundary Pinv rows
  if (tid < NX) {
    ue[tid] = band_row(PinvL, re, tid);
  } else if (tid >= 32 && tid < 32 + NX) {
    ue[(L + 1) * NX + tid - 32] = band_row(PinvR, re + (L + 1) * NX, tid - 32);
  }
  __syncthreads();
  float ru = 0.f, wu = 0.f, rr = 0.f;
  for (int i = tid; i < n; i += nth) {
    const int k = i / NX, c = i - k * NX;
    const float wi = band_row(S + (size_t)k * 3 * NN, ue + k * NX, c);
    const float ui = ue[NX + i], ri = re[2 * NX + i];
    u[i] = ui;
    w[i] = wi;
    ru += ri * ui;
    wu += wi * ui;
    rr += ri * ri;
    // the packets this shard sends: [r, w, s] x [second, edge] rows, last
    // two (to the right) then first two (to the left)
    if (k >= L - 2) {
      float* pl = pkt + (k - (L - 2)) * NX + c;
      pl[0] = ri;
      pl[2 * NX] = wi;
      pl[4 * NX] = s[i];
    }
    if (k < 2) {
      float* pf = pkt + 6 * NX + k * NX + c;
      pf[0] = ri;
      pf[2 * NX] = wi;
      pf[4 * NX] = s[i];
    }
  }
  ru = block_sum(ru, red);
  wu = block_sum(wu, red);
  rr = block_sum(rr, red);
  if (tid == 0) {
    dots[0] = ru;
    dots[1] = wu;
    dots[2] = rr;
    if (!init) {
      scal[0] = eta;
      scal[1] = alpha;
      iters[b] = it + 1;
    }
  }
}

}  // namespace

// n_shard shards, one block each: shard b steps the b-th (L, NX) slab of x,
// r, p, s, u, w, reads its system from S / Pinv + b sys_bstride (L knots of
// 3 NX x NX blocks), its packets flp, frp (6, NX), its neighbours' Pinv
// rows PinvL, PinvR (3, NX, NX), the summed dots tot + b tot_bstride (eta,
// d, r.r), its scalars scal (eta_prev, alpha_prev) and iters[b], and writes
// its partial dots (3) and packets pkt (2, 6, NX)
extern "C" int pcg_slab_launch(float* x, float* r, float* p, float* s,
                               float* u, float* w, const float* S,
                               const float* Pinv, int sys_bstride,
                               const float* flp, const float* frp,
                               const float* PinvL, const float* PinvR,
                               const float* tot, int tot_bstride, float* scal,
                               int* iters, float* dots, float* pkt, int L,
                               int n_shard, int threads, int max_iter,
                               const float* tol, int rnorm, int init,
                               void* stream) {
  const size_t smem = (size_t)(2 * L + 6) * NX * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pcg_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pcg_slab_kernel<<<n_shard, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, r, p, s, u, w, S, Pinv, sys_bstride, flp, frp, PinvL, PinvR, tot,
      tot_bstride, scal, iters, dots, pkt, L, max_iter, tol, rnorm, init);
  return static_cast<int>(cudaGetLastError());
}
