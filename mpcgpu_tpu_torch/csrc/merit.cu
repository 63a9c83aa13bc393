// K3: the line-search merits of every candidate xu + alpha dz in one launch.
//
// Replaces the TPU kernel mpcgpu_tpu/solver/merit_pallas.py::
// line_search_merits_pallas (_make_merit_kernel).  For candidate a
// (alpha_0 = 0, alpha_a = -1/2^(a-1)) and knot k it runs articulated-body
// forward dynamics, the integrator defect |x_{k+1} - f(x_k, u_k)|_1 to the
// next knot's candidate (none at k = N-1), and the ee tracking cost
// 1/2 (|ee - goal|^2 + QD |qd|^2 + R |u|^2) with no control term at k = N-1.
// The merit is sum_k cost + mu (sum_k defect + |x_0 - xs|_1).
//
// What bounds it on an H100: latency and registers.  Each of A x N threads
// (9 x 64 on the main path) runs a serial ABA over 7 links holding per-link
// spatial vectors and a 6x6 articulated inertia, which spill to local
// memory; the work is ~20 KFLOP per thread.  Design: one block per alpha,
// one thread per knot (a block loops over knots when N exceeds its width).
// A thread forms its own candidate and the next knot's candidate from xu and
// dz, so the defect needs no sync; the per-knot terms are then summed by a
// fixed-order block reduction, so the merits are deterministic.  The
// batched solve launches it over a (candidate, instance) grid, the
// instance in blockIdx.y (the JAX package vmaps the TPU kernel there,
// batched_fused.py:499); each instance's merits are the single launch's.
//
// K9c replaces mpcgpu_tpu/solver/merit_pallas.py::
// line_search_merit_partials_slab (the same _make_merit_kernel on one knot
// shard's slab).  It is K3 over a (candidate, shard) grid that writes each
// knot's cost and defect terms instead of summing them: the sum, the
// boundary corrections (the global last knot's control term and defect,
// the initial-state residual) and the cross-shard sum are the caller's.  A
// shard's slab is its L knots plus its right neighbour's first knot, so the
// defect of its last knot sees the next candidate.  Per knot the terms are
// K3's arithmetic; bound as K3.
#include "common.cuh"

using namespace mpc;

namespace {

__global__ void __launch_bounds__(512)
merit_kernel(const float* __restrict__ xu, const float* __restrict__ dz,
             const float* __restrict__ xs, const float* __restrict__ goal,
             int goal_stride, int goal_bstride,
             const float* __restrict__ model, float gravity, float qd_cost,
             float r_cost, float mu, float dt, int N, int integrator_type,
             int wrap, float* __restrict__ merits,
             float* __restrict__ alphas, float* __restrict__ part) {
  __shared__ float sm[MODEL_SIZE];
  __shared__ float red[33];
  const int a = blockIdx.x, tid = threadIdx.x;
  // instance or shard blockIdx.y (the batched solve, K9c; one instance
  // otherwise)
  const int b = blockIdx.y;
  xu += (size_t)b * N * W;
  dz += (size_t)b * N * W;
  goal += (size_t)b * goal_bstride;
  alphas += (size_t)b * gridDim.x;
  // K9c: each knot's (cost, defect) into part (shards, 2, candidates, N)
  float* part_cost = part != nullptr
      ? part + ((size_t)b * 2 * gridDim.x + a) * N : nullptr;
  float* part_defect = part != nullptr ? part_cost + (size_t)gridDim.x * N
                                       : nullptr;
  const float alpha = a == 0 ? 0.f : -ldexpf(1.f, -(a - 1));
  load_model(sm, model);
  __syncthreads();

  float cost_sum = 0.f, defect_sum = 0.f;
  for (int k = tid; k < N; k += blockDim.x) {
    float x[W], s[NQ], c[NQ], qdd[NQ], xn[NX], ee[3];
    for (int i = 0; i < W; ++i) x[i] = xu[k * W + i] + alpha * dz[k * W + i];
    for (int j = 0; j < NQ; ++j) {
      s[j] = sinf(x[j]);
      c[j] = cosf(x[j]);
    }
    float d = 0.f;
    if (k < N - 1) {
      aba(sm, s, c, x + NQ, x + NX, gravity, qdd);
      integrate(x, x + NQ, qdd, dt, integrator_type, wrap, xn);
      for (int i = 0; i < NX; ++i) {
        const float xk1 = xu[(k + 1) * W + i] + alpha * dz[(k + 1) * W + i];
        d += fabsf(xk1 - xn[i]);
      }
      defect_sum += d;
    }
    fk_ee(sm, s, c, ee);
    float pos = 0.f, qdp = 0.f, up = 0.f;
    for (int r = 0; r < 3; ++r) {
      const float e = ee[r] - goal[k * goal_stride + r];
      pos += e * e;
    }
    for (int j = 0; j < NQ; ++j) qdp += x[NQ + j] * x[NQ + j];
    for (int j = 0; j < NU; ++j) up += x[NX + j] * x[NX + j];
    const float cost_k = 0.5f * (pos + qd_cost * qdp + (k < N - 1 ? r_cost * up : 0.f));
    cost_sum += cost_k;
    if (part != nullptr) {
      part_cost[k] = cost_k;
      part_defect[k] = d;
    }
  }
  if (tid == 0) alphas[a] = alpha;
  if (part != nullptr) return;
  const float cost_tot = block_sum(cost_sum, red);
  const float defect_tot = block_sum(defect_sum, red);
  if (tid == 0) {
    xs += (size_t)b * NX;
    float x0 = 0.f;
    for (int i = 0; i < NX; ++i) x0 += fabsf(xu[i] + alpha * dz[i] - xs[i]);
    merits[(size_t)b * gridDim.x + a] = cost_tot + mu * (defect_tot + x0);
  }
}

}  // namespace

// batch instances side by side: instance b reads the b-th (N, W) slab of
// xu and dz, xs[b], goal + b goal_bstride, and writes row b of merits and
// alphas (batch, num_cand)
extern "C" int merit_launch(const float* xu, const float* dz, const float* xs,
                            const float* goal, int goal_stride,
                            int goal_bstride, const float* model,
                            float gravity, float qd_cost, float r_cost,
                            float mu, float dt, int N, int num_cand,
                            int batch, int threads, int integrator_type,
                            int wrap, float* merits, float* alphas,
                            void* stream) {
  merit_kernel<<<dim3(num_cand, batch), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      xu, dz, xs, goal, goal_stride, goal_bstride, model, gravity, qd_cost,
      r_cost, mu, dt, N, integrator_type, wrap, merits, alphas, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K9c: shards side by side: shard b reads the b-th (N, W) slab of xu and dz
// (its L knots and the next shard's first) and goal + b goal_bstride, and
// writes part[b] (2, num_cand, N): each knot's cost, then its defect (0 at
// the slab's last knot), and the candidates' alphas (n_shard, num_cand)
extern "C" int merit_partials_launch(
    const float* xu, const float* dz, const float* goal, int goal_stride,
    int goal_bstride, const float* model, float gravity, float qd_cost,
    float r_cost, float dt, int N, int num_cand, int n_shard, int threads,
    int integrator_type, float* part, float* alphas, void* stream) {
  merit_kernel<<<dim3(num_cand, n_shard), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      xu, dz, nullptr, goal, goal_stride, goal_bstride, model, gravity,
      qd_cost, r_cost, 0.f, dt, N, integrator_type, 0, nullptr, alphas, part);
  return static_cast<int>(cudaGetLastError());
}
