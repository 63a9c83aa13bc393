// K3: the line-search merits of every candidate xu + alpha dz in one launch.
//
// Replaces the TPU kernel mpcgpu_tpu/solver/merit_pallas.py::
// line_search_merits_pallas (_make_merit_kernel).  For candidate a
// (alpha_0 = 0, alpha_a = -1/2^(a-1); without the zero candidate, the
// wrappers' include_zero=False, alpha_a = -1/2^a) and knot k it runs
// articulated-body forward dynamics, the integrator defect
// |x_{k+1} - f(x_k, u_k)|_1 to the next knot's candidate (none at k = N-1),
// and the ee tracking cost 1/2 (|ee - goal|^2 + QD |qd|^2 + R |u|^2) with
// no control term at k = N-1.
// The merit is sum_k cost + mu (sum_k defect + |x_0 - xs|_1).
//
// What bounds it on an H100: latency at one instance (9 x 64 samples),
// instruction issue at 256.  Each (candidate, knot) sample is a serial ABA
// over NQ links (~20 KFLOP at NQ = 7) whose per-link spatial vectors and 6x6
// articulated inertias (~400 floats) do not fit one thread's 128 registers
// at 512 threads a block.  Every mapping below spreads per-link entries over
// a team's lanes with a stride (map_entries), so it holds at any NQ; the
// sample's state (SAMPLE_FLOATS, 76 NQ + 158) follows NQ.  Design: a (candidate, instance, knot chunk)
// grid, a team of G lanes per sample (G a power of two <= 32, a template
// parameter), P samples a block, nothing spilled
// (solver/merit_cuda.py::merit_team_plan picks G and P by the sample count,
// from the team sweep of tools/torch_port_kernel_ab.py):
//   - G = 1 (above 4096 samples): the one-thread recursion (aba, integrate,
//     fk_ee) with its 6x6 matrices in registers (at most 128 threads a
//     block, so up to 255 registers a thread) and its per-link vectors in
//     the thread's shared memory;
//   - G > 1 (G = 16 up to 4096 samples): every sample's state in shared
//     memory; the team splits the output entries of each step of the ABA's
//     three passes (velocities and bias forces; the articulated inertias
//     tip to base; the accelerations) and of the ee transform chain, one
//     entry per lane, with a warp barrier between dependent steps.
// Each entry is summed as the one-thread recursion (common.cuh::aba, fk_ee)
// sums it, so the merits do not depend on G or P.  The per-knot terms are
// summed in the order of the one-thread-per-knot design: each of
// red_threads = min(512, 32 ceil(N / 32)) virtual threads sums knots tid,
// tid + red_threads, ... and block_sum's fixed tree adds the partials, by
// the block that holds all N knots or, when they span several blocks, by the
// last of them to finish (from the others' terms in global scratch).  The
// batched solve launches it with the instance in blockIdx.y (the JAX
// package vmaps the TPU kernel there, batched_fused.py:499); each
// instance's merits are the single launch's.
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

// one sample's state in shared memory, in floats
constexpr int S_X = 0;                   // the candidate's knot row (W)
constexpr int S_SIN = S_X + W;           // sin q, cos q
constexpr int S_COS = S_SIN + NQ;
constexpr int S_V = S_COS + NQ;          // v of every link (NQ x 6)
constexpr int S_IV = S_V + NQ * 6;       // I v
constexpr int S_CB = S_IV + NQ * 6;      // v x (e_z qd)
constexpr int S_PA = S_CB + NQ * 6;      // bias forces pA
constexpr int S_U = S_PA + NQ * 6;       // U = IA[:, 2]
constexpr int S_D = S_U + NQ * 6;        // d = IA[2][2]
constexpr int S_UU = S_D + NQ;           // u - pA[2]
constexpr int S_IA = S_UU + NQ;          // articulated inertia (36)
constexpr int S_IAA = S_IA + M66;        // Ia = IA - U U^T / d
constexpr int S_IAX = S_IAA + M66;       // Ia X
constexpr int S_PAV = S_IAX + M66;       // pa (6)
constexpr int S_AP = S_PAV + 6;          // accelerations, ping-pong (2 x 6)
constexpr int S_QDD = S_AP + 12;
constexpr int S_XN = S_QDD + NQ;         // the integrated state (NX)
constexpr int S_T4 = S_XN + NX;          // ee chain, ping-pong (2 x 16)
constexpr int S_XJ = S_T4 + 32;          // X_j of every joint (NQ x 36)
constexpr int SAMPLE_FLOATS = S_XJ + NQ * M66;
constexpr int SAMPLE_STRIDE = SAMPLE_FLOATS | 1;   // odd: no bank read twice

// one thread's per-link vectors (G = 1): aba's vec, at an odd stride
constexpr int VEC_STRIDE = ABA_VEC | 1;

// Dynamic shared memory of a block of P samples at N knots: the model, the
// samples (G = 1: their vectors), each knot's cost and defect, block_sum's
// 33 floats.  Mirrored by solver/merit_cuda.py::merit_smem_bytes.
__host__ __device__ constexpr int merit_smem_floats(int G, int P, int N) {
  return MODEL_SIZE + P * (G == 1 ? VEC_STRIDE : SAMPLE_STRIDE) + 2 * N + 33;
}

// The ABA of one sample (common.cuh::aba) by its team: lane li of G, team
// barrier sync().  The candidate row in S_X, sin / cos in S_SIN, S_COS and
// the joint transforms in S_XJ; writes qdd to S_QDD.
template <int G, class Sync>
__device__ void aba_team(const float* m, float* st, float gravity, int li,
                         Sync sync) {
  const float* qd = st + S_X + NQ;
  const float* u = st + S_X + NX;
  const float* I = m + OFF_I;
  // velocities and bias forces, base to tip
  for (int j = 0; j < NQ; ++j) {
    const float* X = st + S_XJ + j * M66;
    float* v = st + S_V + j * 6;
    map_entries<6, G>(li, [&](int i) {
      float acc = 0.f;
      if (j > 0) {
        const float* vp = v - 6;
#pragma unroll
        for (int k = 0; k < 6; ++k) acc += X[i * 6 + k] * vp[k];
      } else {
#pragma unroll
        for (int k = 0; k < 6; ++k) acc += X[i * 6 + k] * 0.f;
      }
      if (i == 2) acc += qd[j];
      return acc;
    }, [&](int i, float val) { v[i] = val; });
    sync();
    map_entries<12, G>(li, [&](int e) {
      if (e < 6) {
        // cross_ez_add(v, qd_j, cb_j) onto zeros
        float cbv = 0.f;
        if (e == 0) cbv += qd[j] * v[1];
        else if (e == 1) cbv += qd[j] * -v[0];
        else if (e == 3) cbv += qd[j] * v[4];
        else if (e == 4) cbv += qd[j] * -v[3];
        return cbv;
      }
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += I[j * M66 + (e - 6) * 6 + k] * v[k];
      return acc;
    }, [&](int e, float val) {
      if (e < 6) st[S_CB + j * 6 + e] = val;
      else st[S_IV + j * 6 + e - 6] = val;
    });
    sync();
    map_entries<6, G>(li, [&](int i) {
      // crf_add(v, Iv, pA_j) onto zeros
      const float* f = st + S_IV + j * 6;
      float pa = 0.f;
      if (i < 3) pa += cross3_i(v, f, i) + cross3_i(v + 3, f + 3, i);
      else pa += cross3_i(v, f + 3, i - 3);
      return pa;
    }, [&](int i, float val) { st[S_PA + j * 6 + i] = val; });
  }
  map_entries<M66, G>(li, [&](int e) { return I[(NQ - 1) * M66 + e]; },
                      [&](int e, float val) { st[S_IA + e] = val; });
  sync();
  // articulated inertias, tip to base
  float* IA = st + S_IA;
  float* Ia = st + S_IAA;
  float* IaX = st + S_IAX;
  float* pav = st + S_PAV;
  for (int j = NQ - 1; j >= 0; --j) {
    const float* X = st + S_XJ + j * M66;
    const float* pAj = st + S_PA + j * 6;
    const float dj = IA[2 * 6 + 2];
    // U, d and uu of this link (entries 0..7), Ia = IA - U U^T / d (8..43)
    map_entries<8 + M66, G>(li, [&](int e) {
      if (e < 6) return IA[e * 6 + 2];
      if (e == 6) return dj;
      if (e == 7) return u[j] - pAj[2];
      const int ab = e - 8, a = ab / 6, b = ab % 6;
      return IA[a * 6 + b] - div_rn(IA[a * 6 + 2] * IA[b * 6 + 2], dj);
    }, [&](int e, float val) {
      if (e < 6) st[S_U + j * 6 + e] = val;
      else if (e == 6) st[S_D + j] = val;
      else if (e == 7) st[S_UU + j] = val;
      else if (j > 0) Ia[e - 8] = val;
    });
    if (j == 0) break;
    sync();
    const float uuj = u[j] - pAj[2];
    map_entries<6 + M66, G>(li, [&](int e) {
      if (e < 6) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) t += Ia[e * 6 + k] * st[S_CB + j * 6 + k];
        const float ud = div_rn(uuj, dj);
        return pAj[e] + t + IA[e * 6 + 2] * ud;
      }
      const int ab = e - 6, a = ab / 6, b = ab % 6;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += Ia[a * 6 + k] * X[k * 6 + b];
      return acc;
    }, [&](int e, float val) {
      if (e < 6) pav[e] = val;
      else IaX[e - 6] = val;
    });
    sync();
    const float* Ip = I + (j - 1) * M66;
    float* pAp = st + S_PA + (j - 1) * 6;
    map_entries<M66 + 6, G>(li, [&](int e) {
      if (e < M66) {
        const int a = e / 6, b = e % 6;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) acc += X[k * 6 + a] * IaX[k * 6 + b];
        return Ip[e] + acc;
      }
      const int i = e - M66;
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) t += X[k * 6 + i] * pav[k];
      return pAp[i] + t;
    }, [&](int e, float val) {
      if (e < M66) IA[e] = val;
      else pAp[e - M66] = val;
    });
    sync();
  }
  sync();
  // accelerations, base to tip
  float* apar = st + S_AP;
  if (li == 0)
    for (int i = 0; i < 6; ++i) apar[i] = i == 5 ? gravity : 0.f;
  sync();
  for (int j = 0; j < NQ; ++j) {
    const float* X = st + S_XJ + j * M66;
    float* ap = st + S_AP + ((j + 1) & 1) * 6;
    const float* apr = st + S_AP + (j & 1) * 6;
    map_entries<6, G>(li, [&](int i) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += X[i * 6 + k] * apr[k];
      acc += st[S_CB + j * 6 + i];
      return acc;
    }, [&](int i, float val) { ap[i] = val; });
    sync();
    if (li == 0) {
      const float* Uj = st + S_U + j * 6;
      float dot = 0.f;
      for (int i = 0; i < 6; ++i) dot += Uj[i] * ap[i];
      const float q = div_rn(st[S_UU + j] - dot, st[S_D + j]);
      st[S_QDD + j] = q;
      ap[2] += q;
    }
    sync();
  }
}

// common.cuh::fk_ee by the team: ee -> out[0..3)
template <int G, class Sync>
__device__ void fk_team(const float* m, float* st, int li, Sync sync, float* out) {
  const float* s = st + S_SIN;
  const float* c = st + S_COS;
  float* T = st + S_T4;
  map_entries<16, G>(li, [&](int e) {
    return m[OFF_HC + e] + s[0] * m[OFF_HS + e] + c[0] * m[OFF_HCOS + e];
  }, [&](int e, float v) { T[e] = v; });
  for (int j = 1; j < NQ; ++j) {
    sync();
    const float* Tc = st + S_T4 + ((j + 1) & 1) * 16;
    float* Tn = st + S_T4 + (j & 1) * 16;
    map_entries<16, G>(li, [&](int e) {
      const int i = e / 4, l = e % 4;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = OFF_HC + j * 16 + k * 4 + l;
        acc += Tc[i * 4 + k] * (m[h] + s[j] * m[h + NQ * 16] + c[j] * m[h + 2 * NQ * 16]);
      }
      return acc;
    }, [&](int e, float v) { Tn[e] = v; });
  }
  sync();
  const float* Tf = st + S_T4 + ((NQ - 1) & 1) * 16;
  out[0] = Tf[3];
  out[1] = Tf[7];
  out[2] = Tf[11];
}

// the most threads of a block: teams, and G <= 2 (G = 1: the registers hold
// the 6x6 matrices; G = 2: each lane's half of a 44-entry step), at most
// 255 registers a thread
constexpr int MERIT_MAX_THREADS = 512;
constexpr int MERIT_MAX_THREADS_G1 = 128;
__host__ __device__ constexpr int merit_max_threads(int G) {
  return G <= 2 ? MERIT_MAX_THREADS_G1 * G : MERIT_MAX_THREADS;
}

template <int G>
__global__ void __launch_bounds__(merit_max_threads(G))
merit_kernel(const float* __restrict__ xu, const float* __restrict__ dz,
             const float* __restrict__ xs, const float* __restrict__ goal,
             int goal_stride, int goal_bstride,
             const float* __restrict__ model, float gravity, float qd_cost,
             float r_cost, float mu, float dt, int N, int P, int red_threads,
             int integrator_type, int wrap, int zero,
             float* __restrict__ merits,
             float* __restrict__ alphas, float* __restrict__ part,
             float* __restrict__ terms, int* __restrict__ done) {
  extern __shared__ __align__(16) float dsm[];
  float* sm = dsm;
  float* samples = sm + MODEL_SIZE;
  float* cost_k = samples + P * (G == 1 ? VEC_STRIDE : SAMPLE_STRIDE);
  float* defect_k = cost_k + N;
  float* red = defect_k + N;
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
  // powers of two are exact: the plain version's -1 / 2^i bit for bit
  const float alpha = !zero ? -ldexpf(1.f, -a)
                            : a == 0 ? 0.f : -ldexpf(1.f, -(a - 1));
  load_model(sm, model);
  __syncthreads();

  // this block's round: the samples (knots) k0 .. k0 + P - 1
  const int k0 = blockIdx.z * P;
  const int team = tid / G, li = tid % G;
  const int lane = tid & 31;
  if constexpr (G == 1) {
    // one thread per sample: the one-thread recursion (aba, integrate,
    // fk_ee) with its 6x6 matrices in registers and its per-link vectors in
    // the thread's shared memory
    float* vec = samples + tid * VEC_STRIDE;
    if (const int k = k0 + tid; k < N) {
      float x[W], s[NQ], c[NQ], qdd[NQ], xn[NX], ee[3];
      for (int i = 0; i < W; ++i) x[i] = xu[k * W + i] + alpha * dz[k * W + i];
      for (int j = 0; j < NQ; ++j) {
        s[j] = sinf(x[j]);
        c[j] = cosf(x[j]);
      }
      float d = 0.f;
      if (k < N - 1) {
        aba(sm, s, c, x + NQ, x + NX, gravity, qdd, vec);
        integrate(x, x + NQ, qdd, dt, integrator_type, wrap, xn);
        for (int i = 0; i < NX; ++i) {
          const float xk1 = xu[(k + 1) * W + i] + alpha * dz[(k + 1) * W + i];
          d += fabsf(xk1 - xn[i]);
        }
      }
      fk_ee(sm, s, c, ee);
      float pos = 0.f, qdp = 0.f, up = 0.f;
      for (int r = 0; r < 3; ++r) {
        const float e = ee[r] - goal[k * goal_stride + r];
        pos += e * e;
      }
      for (int j = 0; j < NQ; ++j) qdp += x[NQ + j] * x[NQ + j];
      for (int j = 0; j < NU; ++j) up += x[NX + j] * x[NX + j];
      const float ck = 0.5f * (pos + qd_cost * qdp + (k < N - 1 ? r_cost * up : 0.f));
      cost_k[k] = ck;
      defect_k[k] = d;
      if (part != nullptr) {
        part_cost[k] = ck;
        part_defect[k] = d;
      }
    }
  }
  // a team of G > 1 lanes per sample: every team of a warp runs every round
  // and the whole ABA in step, so the team barriers are the warp's (a
  // barrier over part of a warp would let the teams drift apart and the
  // warp issue each team's steps in turn): a sample past the horizon repeats
  // the last knot and writes nothing, the last knot runs the ABA and
  // ignores it
  const auto sync = []() { __syncwarp(); };
  float* st = samples + team * SAMPLE_STRIDE;
  if constexpr (G > 1) {
    const bool live = k0 + team < N;
    const int k = live ? k0 + team : N - 1;
    FOR_STRIDED(i, li, W, G) st[S_X + i] = xu[k * W + i] + alpha * dz[k * W + i];
    sync();
    map_entries<NQ, G>(li, [&](int j) { return st[S_X + j]; }, [&](int j, float q) {
      st[S_SIN + j] = sinf(q);
      st[S_COS + j] = cosf(q);
    });
    sync();
    // every joint's X_j (xmat's arithmetic), read by the three passes
    map_entries<NQ * M66, G>(li, [&](int e) {
      const int j = e / M66;
      return sm[OFF_XC + e] + st[S_SIN + j] * sm[OFF_XS + e] +
             st[S_COS + j] * sm[OFF_XCOS + e];
    }, [&](int e, float v) { st[S_XJ + e] = v; });
    sync();
    aba_team<G>(sm, st, gravity, li, sync);
    FOR_STRIDED(j, li, NQ, G) {
      const float* x = st + S_X;
      const float* qdd = st + S_QDD;
      float* xn = st + S_XN;
      const float qdn = x[NQ + j] + dt * qdd[j];
      const float qn = integrator_type == 0 ? x[j] + dt * x[NQ + j] : x[j] + dt * qdn;
      xn[j] = wrap ? angle_wrap(qn) : qn;
      xn[NQ + j] = qdn;
    }
    sync();
    float d = 0.f;
    if (li == 0 && k < N - 1)
      for (int i = 0; i < NX; ++i) {
        const float xk1 = xu[(k + 1) * W + i] + alpha * dz[(k + 1) * W + i];
        d += fabsf(xk1 - st[S_XN + i]);
      }
    float ee[3];
    fk_team<G>(sm, st, li, sync, ee);
    if (li == 0 && live) {
      const float* x = st + S_X;
      float pos = 0.f, qdp = 0.f, up = 0.f;
      for (int r = 0; r < 3; ++r) {
        const float e = ee[r] - goal[k * goal_stride + r];
        pos += e * e;
      }
      for (int j = 0; j < NQ; ++j) qdp += x[NQ + j] * x[NQ + j];
      for (int j = 0; j < NU; ++j) up += x[NX + j] * x[NX + j];
      const float ck = 0.5f * (pos + qd_cost * qdp + (k < N - 1 ? r_cost * up : 0.f));
      cost_k[k] = ck;
      defect_k[k] = d;
      if (part != nullptr) {
        part_cost[k] = ck;
        part_defect[k] = d;
      }
    }
    sync();
  }
  if (tid == 0) alphas[a] = alpha;
  if (part != nullptr) return;
  __syncthreads();
  if (gridDim.z > 1) {
    // the knots are spread over gridDim.z blocks: each writes its terms, and
    // the last of them to finish sums all, in the same order
    float* tc = terms + ((size_t)b * gridDim.x + a) * 2 * N;
    for (int k = k0 + tid; k < min(N, k0 + P); k += blockDim.x) {
      tc[k] = cost_k[k];
      tc[N + k] = defect_k[k];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      red[0] = atomicAdd(done + (size_t)b * gridDim.x + a, 1) == (int)gridDim.z - 1;
    __syncthreads();
    if (red[0] == 0.f) return;
    for (int k = tid; k < N; k += blockDim.x) {
      cost_k[k] = __ldcg(tc + k);
      defect_k[k] = __ldcg(tc + N + k);
    }
    if (tid == 0) done[(size_t)b * gridDim.x + a] = 0;   // ready for the next launch
    __syncthreads();
  }
  // the one-thread-per-knot design's sums: virtual thread v of red_threads
  // sums knots v, v + red_threads, ... in order (the defect over k < N - 1),
  // then block_sum's tree: each virtual warp's shuffle-down tree, then the
  // warp parts by warp 0
  const int nwarps = blockDim.x >> 5, warp = tid >> 5;
  const int vwarps = red_threads >> 5;
  float tot[2];
  for (int which = 0; which < 2; ++which) {
    const float* terms = which == 0 ? cost_k : defect_k;
    const int kend = which == 0 ? N : N - 1;
    for (int vw = warp; vw < vwarps; vw += nwarps) {
      float v = 0.f;
      for (int k = vw * 32 + lane; k < kend; k += red_threads) v += terms[k];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) red[vw] = v;
    }
    __syncthreads();
    if (warp == 0) {
      float v = lane < vwarps ? red[lane] : 0.f;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) red[32] = v;
    }
    __syncthreads();
    tot[which] = red[32];
    __syncthreads();
  }
  if (tid == 0) {
    xs += (size_t)b * NX;
    float x0 = 0.f;
    for (int i = 0; i < NX; ++i) x0 += fabsf(xu[i] + alpha * dz[i] - xs[i]);
    merits[(size_t)b * gridDim.x + a] = tot[0] + mu * (tot[1] + x0);
  }
}

template <int G>
int launch_team(dim3 grid, int P, int smem, cudaStream_t st, const float* xu,
                const float* dz, const float* xs, const float* goal,
                int goal_stride, int goal_bstride, const float* model,
                float gravity, float qd_cost, float r_cost, float mu, float dt,
                int N, int red_threads, int integrator_type, int wrap,
                int zero, float* merits, float* alphas, float* part,
                float* terms, int* done) {
  // the attribute is the kernel's on each device; set it when a launch
  // needs more
  static int smem_set[64] = {};
  int device = 0;
  cudaGetDevice(&device);
  int& have = smem_set[device & 63];
  if (smem > have) {
    const cudaError_t err = cudaFuncSetAttribute(
        merit_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    have = smem;
  }
  merit_kernel<G><<<grid, P * G, smem, st>>>(
      xu, dz, xs, goal, goal_stride, goal_bstride, model, gravity, qd_cost,
      r_cost, mu, dt, N, P, red_threads, integrator_type, wrap, zero, merits,
      alphas, part, terms, done);
  return static_cast<int>(cudaGetLastError());
}

// team G lanes per sample, P samples per block (P G threads, a multiple of
// 32, at most merit_max_threads(G)), ceil(N / P) blocks per candidate and
// instance, smem bytes (checked against the kernel's own count); the
// reduction of red_threads = min(512, 32 ceil(N / 32)) virtual threads.
// With more than one block per candidate (and no part), terms holds 2 N
// floats and done one zeroed int per candidate and instance.
int launch(dim3 grid, int G, int P, int smem, cudaStream_t st, const float* xu,
           const float* dz, const float* xs, const float* goal,
           int goal_stride, int goal_bstride, const float* model, float gravity,
           float qd_cost, float r_cost, float mu, float dt, int N,
           int integrator_type, int wrap, int zero, float* merits,
           float* alphas, float* part, float* terms, int* done) {
  const int red_threads = min(512, (N + 31) / 32 * 32);
  grid.z = (N + P - 1) / P;
  if (grid.z > 1 && part == nullptr && (terms == nullptr || done == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P < 1 || P * G > merit_max_threads(G) || P * G < 32 || (P * G) % 32 != 0 ||
      smem != static_cast<int>(sizeof(float)) * merit_smem_floats(G, P, N))
    return static_cast<int>(cudaErrorInvalidValue);
#define MERIT_TEAM(g)                                                        \
  case g:                                                                    \
    return launch_team<g>(grid, P, smem, st, xu, dz, xs, goal, goal_stride,  \
                          goal_bstride, model, gravity, qd_cost, r_cost, mu, \
                          dt, N, red_threads, integrator_type, wrap, zero,   \
                          merits, alphas, part, terms, done);
  switch (G) {
    MERIT_TEAM(1)
    MERIT_TEAM(2)
    MERIT_TEAM(4)
    MERIT_TEAM(8)
    MERIT_TEAM(16)
    MERIT_TEAM(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MERIT_TEAM
}

}  // namespace

// batch instances side by side: instance b reads the b-th (N, W) slab of
// xu and dz, xs[b], goal + b goal_bstride, and writes row b of merits and
// alphas (batch, num_cand); teams of G lanes, P samples per block, smem
// bytes (solver/merit_cuda.py::merit_team_plan); terms (2 N batch num_cand
// floats) and done (batch num_cand ints, zero, and zero again after the
// launch) when N > P; zero: candidate 0 is alpha = 0 (include_zero)
extern "C" int merit_launch(const float* xu, const float* dz, const float* xs,
                            const float* goal, int goal_stride,
                            int goal_bstride, const float* model,
                            float gravity, float qd_cost, float r_cost,
                            float mu, float dt, int N, int num_cand,
                            int batch, int G, int P, int smem,
                            int integrator_type, int wrap, int zero,
                            float* merits, float* alphas, float* terms,
                            int* done, void* stream) {
  return launch(dim3(num_cand, batch), G, P, smem,
                static_cast<cudaStream_t>(stream), xu, dz, xs, goal,
                goal_stride, goal_bstride, model, gravity, qd_cost, r_cost,
                mu, dt, N, integrator_type, wrap, zero, merits, alphas,
                nullptr, terms, done);
}

// K9c: shards side by side: shard b reads the b-th (N, W) slab of xu and dz
// (its L knots and the next shard's first) and goal + b goal_bstride, and
// writes part[b] (2, num_cand, N): each knot's cost, then its defect (0 at
// the slab's last knot), and the candidates' alphas (n_shard, num_cand);
// wrap and zero as merit_launch's
extern "C" int merit_partials_launch(
    const float* xu, const float* dz, const float* goal, int goal_stride,
    int goal_bstride, const float* model, float gravity, float qd_cost,
    float r_cost, float dt, int N, int num_cand, int n_shard, int G, int P,
    int smem, int integrator_type, int wrap, int zero, float* part,
    float* alphas, void* stream) {
  return launch(dim3(num_cand, n_shard), G, P, smem,
                static_cast<cudaStream_t>(stream), xu, dz, nullptr, goal,
                goal_stride, goal_bstride, model, gravity, qd_cost, r_cost,
                0.f, dt, N, integrator_type, wrap, zero, nullptr, alphas, part,
                nullptr, nullptr);
}
