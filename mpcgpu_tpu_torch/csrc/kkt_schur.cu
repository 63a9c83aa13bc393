// K1: KKT assembly + Schur condensation + symmetric-stair preconditioner;
// K5: the KKT blocks alone.
//
// K1 replaces the TPU kernel mpcgpu_tpu/solver/kkt_pallas.py::
// build_kkt_schur_pallas (_make_kkt_schur_kernel, core _kkt_core).  Per knot
// k it linearizes the dynamics (forward-mode RNEA with 2 NQ tangents, CRBA
// mass matrix and its Gauss-Jordan inverse, Euler / semi-implicit Jacobians),
// builds the Gauss-Newton ee-tracking cost with (Q + rho I)^{-1} in closed
// form (Sherman-Morrison), and forms the Schur blocks theta/phi/gamma and the
// 3-band stair preconditioner, in the knot-leading layout of
// mpcgpu_tpu_torch/ops/schur.py.
//
// What bounds it on an H100: latency, not bytes.  Each knot is a chain of
// tiny dependent 6x6 / 14x14 products (~100 KFLOP at NQ = 7) and the outputs
// are ~300 KB at N = 64, so the time is the depth of the dependent steps and
// the syncs between them.
//
// Design: ONE LAUNCH, a WINDOW of Kc consecutive knots per CTA, a GROUP of
// KW warps per knot (3 at NQ = 6, 7; 2 below: one team of 6 lanes per
// tangent direction, 5 teams a warp).  Kc is a fixed function of N (solver/kkt_cuda.py::
// kkt_window_plan), never of the batch, so every caller rounds alike.  CTA w
// owns the knots [s, e) = [w Kc, min(N, (w + 1) Kc)) and has Kc + 3 groups;
// the knot coupling runs in three stages inside the CTA, through shared
// memory, with a block barrier between them:
//   1 knot stage, slots 0 .. Kc + 2 (knots s - 2 .. e): group i linearizes
//     knot s - 2 + i and keeps what the Schur rows need (T = A Qinv A^T +
//     B Rinv B^T, A Qinv, xnext, A Qinv q, B Rinv r, Qinv, q) in its slot;
//   2 Schur stage, slots 1 .. Kc + 2: theta, phi, phi^T, gamma and D =
//     theta^{-1} by Gauss-Jordan, from the slot before;
//   3 stair stage, the own slots 2 .. Kc + 1: -D_k S_{k,k+-1} D_{k+-1}.
// The two halo knots on the left (the stair band at s needs D_{s-1}, which
// needs T_{s-2}) and the one on the right (D_e needs Qinv_e) are computed
// again by the neighbouring windows: (Kc + 3) / Kc knot stages per knot.
// Within a knot the serial chains are spread over the group's KT = 32 KW
// threads, which meet at a named barrier of their own:
//   - the bias RNEA and the 2 NQ tangent RNEAs run on teams of 6 lanes, lane
//     c holding component c of every spatial vector (rnea_team, full-warp
//     shuffles): the bias on warp 0 while the other warps run the ee forward
//     kinematics and its NQ q-derivative columns (every 4x4 product entry on
//     its own thread), then the 2 NQ tangents at once on the group's 5 KW
//     teams;
//   - the CRBA, the Gauss-Jordan inverses, the integrator and every 14x14
//     product spread their output entries over the threads, each thread
//     computing all its entries before it stores any (map_entries: the
//     buffers share one shared-memory array, so a store between them would
//     serialize the loads).
// Every output entry is formed by one thread in the order a one-thread
// recursion forms it: no dot product is split and no sum reordered, so the
// results do not depend on the group or window layout.
// The lane rolls of the TPU kernel become explicit neighbour indices with
// bounds: gamma_0 leaves out c_0, row 0 has no phi, the last row no phi^T,
// the stair bands are zero at the edges.  A and B at the last knot are not
// part of the QP and are written as zeros.
//
// K5 replaces mpcgpu_tpu/solver/kkt_pallas.py::build_kkt_pallas
// (_make_kkt_kernel, the same _kkt_core).  It is the knot stage alone
// (kkt_window_kernel<false>: Kc knot groups per CTA, no halo): per knot it writes
// the Gauss-Newton Q = [[gq gq^T, 0], [0, qd_cost I]], q, A, B and the
// defect c_{k+1} = x_{k+1} - f(x_k, u_k) (knot 0 also c_0 = x_0 - xs), and
// needs no rho, no inverse and no neighbour.  Latency-bound like K1.
//
// K8a replaces mpcgpu_tpu/parallel/batched_fused.py::build_kkt_schur_batched
// (K1 over instance groups packed on lanes).  It is K1's launch over a
// (window, instance) grid: instance blockIdx.y offsets its rows of xu and
// the goal, reads its own rho and writes its own (N, ...) slab of every
// output, with K1's windows, so each instance's result is K1's bit for bit.
//
// K9a replaces mpcgpu_tpu/solver/kkt_pallas.py::build_kkt_schur_pallas_slab
// (_make_kkt_schur_kernel with boundary_masks=True), the shard-local kernel
// of the knot-sharded SQP.  It is K1's launch over a (window, shard) grid,
// each shard a horizon of Lext = L + 4 knots (its own L and two halo knots
// per side: the stair band at a slab's first knot needs D of the knot
// before it, which needs T two knots back), cut into K1's windows.  Where K1
// tests k == 0 and k == N - 1, K9a also reads two runtime flags per knot,
// the GLOBAL first and last knot, so a knot at either end of the shard or
// at an end of the horizon takes the same branch; the caller keeps the L
// interior knots, which are then K1's rows bit for bit.  Bound as K1.
#include "common.cuh"

using namespace mpc;

namespace {

constexpr int NN = NX * NX;                  // 196

// A knot's slot (stage 1 -> stages 2, 3), in floats
constexpr int SL_T = 0;                      // T (NN)
constexpr int SL_AQ = SL_T + NN;             // A Qinv (NN)
constexpr int SL_QI = SL_AQ + NN;            // Qinv (NN)
constexpr int SL_D = SL_QI + NN;             // D = theta^{-1} (NN), stage 2
constexpr int SL_XN = SL_D + NN;             // xnext (NX)
constexpr int SL_AQQ = SL_XN + NX;           // A Qinv q (NX)
constexpr int SL_BRR = SL_AQQ + NX;          // B Rinv r (NX)
constexpr int SL_Q = SL_BRR + NX;            // q (NX)
constexpr int SLOT_FLOATS = SL_Q + NX;       // 840

// A knot's group: KW warps, KT threads, 5 KW teams of 6 lanes for the
// tangent RNEAs (one per direction: 3 warps at NQ = 6, 7, 2 below); the ee
// forward kinematics on the FKT threads past warp 0
constexpr int KW = 2 + (NX > 10);
constexpr int KT = 32 * KW;
constexpr int FKT = KT - 32;
static_assert(5 * KW >= NX, "one team of 6 lanes per tangent direction");
constexpr int KKT_MAX_GROUPS = 7;   // Kc <= 4 with the halo; 2 x 7 named barriers

// A group's working set in the knot stage, in floats
constexpr int WS_X = 0;                      // X_j (NQ x 36)
constexpr int WS_XP = WS_X + NQ * M66;       // dX_j / dq_j
constexpr int WS_IC = WS_XP + NQ * M66;      // composite inertias
constexpr int WS_T36 = WS_IC + NQ * M66;
constexpr int WS_AUG = WS_T36 + M66;         // [M | I] (NQ x 2 NQ)
constexpr int WS_PIV = WS_AUG + NQ * 2 * NQ;
constexpr int WS_FCOL = WS_PIV + 2 * NQ;
constexpr int WS_MINV = WS_FCOL + NQ;
constexpr int WS_CB = WS_MINV + NQ * NQ;     // bias torques
constexpr int WS_QDD = WS_CB + NQ;
constexpr int WS_DID = WS_QDD + NQ;          // dID / d(q, qd) (NQ x NX)
constexpr int WS_DQDD = WS_DID + NQ * NX;
constexpr int WS_A = WS_DQDD + NQ * NX;      // A (NN); the FK buffers before
constexpr int WS_B = WS_A + NN;              // B (NX x NU)
// the FK chain's ping-pong buffers (T, then the NQ columns of dT / dq_t)
// live in A and B, which are written only after the FK is read, and past
// them where A and B are smaller (NQ < 7); then (Q + rho I)^{-1} (NN)
constexpr int FK_BUF = 16 * (NQ + 1);
constexpr int WS_AB = NN + NX * NU;
constexpr int WS_QIW = WS_A + WS_AB + (2 * FK_BUF > WS_AB) * (2 * FK_BUF - WS_AB);
constexpr int WS_GRAD = WS_QIW + NN;
constexpr int WS_XN = WS_GRAD + NX;
constexpr int WS_EE = WS_XN + NX;
constexpr int WS_J = WS_EE + 3;              // ee Jacobian (3 x NQ)
constexpr int WS_X0 = WS_J + 3 * NQ;         // x (NX), u (NU), x_eval (NX)
constexpr int WS_U = WS_X0 + NX;
constexpr int WS_XE = WS_U + NU;
constexpr int WS_GL = WS_XE + NX;
constexpr int WS_SC = WS_GL + 3;             // sin q, cos q, sin xe, cos xe
constexpr int WS_FLOATS = WS_SC + 4 * NQ;    // 1778 at NQ = 7
static_assert(WS_A + 2 * FK_BUF <= WS_QIW, "FK buffers overlap Qinv");
static_assert(3 * (NQ + 1) <= FKT, "the FK's ee entries and Jacobian, a thread each");
// the Schur stage's [theta | I] and the stair stage's two products reuse
// the working set
static_assert(NX * 2 * NX + 2 * NX + NX <= WS_FLOATS, "Schur stage");

// Dynamic shared memory of a CTA of `groups` knot groups (kSchur: Kc + 3
// groups and as many slots; K5: Kc groups, no slot): the model, the slots,
// one working set per group.  Mirrored by solver/kkt_cuda.py::kkt_smem_bytes.
__host__ __device__ constexpr int kkt_smem_floats(int groups, bool schur) {
  return MODEL_SIZE + (schur ? groups * SLOT_FLOATS : 0) + groups * WS_FLOATS;
}

// barrier over the `count` threads (a multiple of 32) of named barrier id
// (1..15; 0 is __syncthreads')
__device__ inline void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// Two or three floats an entry of a map yields.
struct F2 {
  float a, b;
};
struct F3 {
  float a, b, c;
};

// Knot k at the start / end of the horizon.  Without flags (K1, K5, K8a)
// the launch's N knots are the horizon; with them (K9a) bm points at the
// shard's global-first flags bm[0..N) and global-last flags bm[N..2N), and
// the shard's own ends count as ends too (no neighbour in the shard).
__device__ inline bool first_knot(const float* bm, int k) {
  return k == 0 || (bm != nullptr && bm[k] != 0.f);
}
__device__ inline bool last_knot(const float* bm, int N, int k) {
  return k == N - 1 || (bm != nullptr && bm[N + k] != 0.f);
}

// The four components of a spatial vector w that component c of a cross
// product reads (cross3_i's i1 = i + 1, i2 = i - 1 mod 3 of i = c mod 3):
// w[i1], w[i2], w[3 + i1], w[3 + i2].
struct Cross4 {
  float a1, a2, b1, b2;
};

__device__ inline float pick3(const float* w, int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : w[2];
}

// ... picked from every component of w on this lane
__device__ inline Cross4 cross4(const float* w, int i1, int i2) {
  return Cross4{pick3(w, i1), pick3(w, i2), pick3(w + 3, i1), pick3(w + 3, i2)};
}

// ... shuffled from the team's lanes (lane base + j holds w_j)
__device__ inline Cross4 cross4_shfl(float w_own, int base, int i1, int i2) {
  constexpr unsigned full = 0xffffffffu;
  return Cross4{__shfl_sync(full, w_own, base + i1), __shfl_sync(full, w_own, base + i2),
                __shfl_sync(full, w_own, base + 3 + i1),
                __shfl_sync(full, w_own, base + 3 + i2)};
}

// Component c of crf(v) f = [w x fw + vo x fv; w x fv], as crf_add forms
// it: (t0 + t1) for c < 3, t2 for c >= 3, each term cross3_i's a[i1] b[i2]
// - a[i2] b[i1].
__device__ inline float crf_c(const Cross4& v, const Cross4& f, int c) {
  const float t0 = v.a1 * f.a2 - v.a2 * f.a1;
  const float t1 = v.b1 * f.b2 - v.b2 * f.b1;
  const float t2 = v.a1 * f.b2 - v.a2 * f.b1;
  return c < 3 ? t0 + t1 : t2;
}

// component c of M v (6x6, row-major), summed as mv6 sums it
__device__ inline float mv6_c(const float* M, const float* v, int c) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) acc += M[c * 6 + j] * v[j];
  return acc;
}

// component c of M^T v, as mv6t sums it
__device__ inline float mv6t_c(const float* M, const float* v, int c) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) acc += M[j * 6 + c] * v[j];
  return acc;
}

// Forward-mode RNEA with one tangent direction t (t < NQ: d/dq_t;
// NQ <= t < NX: d/dqd_{t-NQ}; t < 0: value only) by a team of 6 lanes
// (first lane base; this lane's component c), every lane of the warp
// calling at once (full-warp shuffles; a team past lane 31 reads garbage
// and must not write).  X/Xp hold the knot's transforms and their
// q-derivatives; qdd == nullptr gives the bias term.  Every component is
// summed as the one-thread recursion sums it (mv6, mv6t, cross_ez_add,
// crf_add, in the same order), the link recursion in order; the terms that
// only one tangent or one component takes are selected, not branched to,
// so the teams of a warp never diverge.  Writes tau[k * stride] (if tau)
// and tau_dot[k * stride] (if tau_dot) from lane c == 0, after the
// recursion.
__device__ void rnea_team(const float* X, const float* Xp, const float* I,
                          const float* qd, const float* qdd, int t,
                          float gravity, int base, int c, float* tau,
                          float* tau_dot, int stride) {
  constexpr unsigned full = 0xffffffffu;
  // every component of v, vd, a, ad on every lane of the team
  float v[6], vd[6], a[6], ad[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    v[i] = 0.f;
    vd[i] = 0.f;
    a[i] = i == 5 ? gravity : 0.f;
    ad[i] = 0.f;
  }
  // this lane's component of each link's force and its tangent
  float f[NQ], fd[NQ];
  // the partner component cross_ez_add reads, and its sign
  const int p = c == 0 ? 1 : c == 1 ? 0 : c == 3 ? 4 : c == 4 ? 3 : c;
  const bool plus = c == 0 || c == 3, minus = c == 1 || c == 4;
  // the components crf_add's cross products at c read
  const int ci = c < 3 ? c : c - 3;
  const int i1 = ci == 2 ? 0 : ci + 1, i2 = ci == 0 ? 2 : ci - 1;
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    const float* Xk = X + k * M66;
    const float* Xpk = Xp + k * M66;
    const bool tk = t == k;
    const float dqd = (t == NQ + k) ? 1.f : 0.f;
    float vn = mv6_c(Xk, v, c);
    float vdn = mv6_c(Xk, vd, c);
    float an = mv6_c(Xk, a, c);
    float adn = mv6_c(Xk, ad, c);
    const float xv = mv6_c(Xpk, v, c), xa = mv6_c(Xpk, a, c);
    vdn = tk ? vdn + xv : vdn;
    adn = tk ? adn + xa : adn;
    vn = c == 2 ? vn + qd[k] : vn;
    vdn = c == 2 ? vdn + dqd : vdn;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      v[i] = __shfl_sync(full, vn, base + i);
      vd[i] = __shfl_sync(full, vdn, base + i);
    }
    const float qk = qd[k];
    const float vp = p == 0 ? v[0] : p == 1 ? v[1] : p == 3 ? v[3] : v[4];
    const float vdp = p == 0 ? vd[0] : p == 1 ? vd[1] : p == 3 ? vd[3] : vd[4];
    const float an_p = an + qk * vp, an_m = an + qk * -vp;
    float adn_p = adn + qk * vdp, adn_m = adn + qk * -vdp;
    adn_p += dqd * vp;
    adn_m += dqd * -vp;
    an = plus ? an_p : minus ? an_m : an;
    adn = plus ? adn_p : minus ? adn_m : adn;
    if (qdd != nullptr) an = c == 2 ? an + qdd[k] : an;
    const float* Ik = I + k * M66;
    const float Iv = mv6_c(Ik, v, c);
    const float Ivd = mv6_c(Ik, vd, c);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      a[i] = __shfl_sync(full, an, base + i);
      ad[i] = __shfl_sync(full, adn, base + i);
    }
    const Cross4 cv = cross4(v, i1, i2), cvd = cross4(vd, i1, i2);
    const Cross4 cIv = cross4_shfl(Iv, base, i1, i2);
    const Cross4 cIvd = cross4_shfl(Ivd, base, i1, i2);
    float fk = mv6_c(Ik, a, c);
    fk += crf_c(cv, cIv, c);
    float fdk = mv6_c(Ik, ad, c);
    fdk += crf_c(cvd, cIv, c);
    fdk += crf_c(cv, cIvd, c);
    f[k] = fk;
    fd[k] = fdk;
  }
  float fc[6], fcd[6], tk[NQ], tdk[NQ];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    fc[i] = __shfl_sync(full, f[NQ - 1], base + i);
    fcd[i] = __shfl_sync(full, fd[NQ - 1], base + i);
  }
#pragma unroll
  for (int k = NQ - 1; k >= 0; --k) {
    tk[k] = fc[2];
    tdk[k] = fcd[2];
    if (k > 0) {
      const float n = mv6t_c(X + k * M66, fc, c);
      float nd = mv6t_c(X + k * M66, fcd, c);
      const float xn = mv6t_c(Xp + k * M66, fc, c);
      nd = t == k ? nd + xn : nd;
      const float fk = f[k - 1] + n, fdk = fd[k - 1] + nd;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        fc[i] = __shfl_sync(full, fk, base + i);
        fcd[i] = __shfl_sync(full, fdk, base + i);
      }
    }
  }
  if (c == 0) {
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      if (tau != nullptr) tau[k * stride] = tk[k];
      if (tau_dot != nullptr) tau_dot[k * stride] = tdk[k];
    }
  }
}

// entry e of H_j (4x4, as hmat forms it) and of dH_j / dq_j (hmat_d)
__device__ inline float hmat_e(const float* m, int j, float s, float c, int e) {
  return m[OFF_HC + j * 16 + e] + s * m[OFF_HS + j * 16 + e] + c * m[OFF_HCOS + j * 16 + e];
}
__device__ inline float hmat_d_e(const float* m, int j, float s, float c, int e) {
  return c * m[OFF_HS + j * 16 + e] - s * m[OFF_HCOS + j * 16 + e];
}

// The ee position and its q-derivative columns (fk_dual of each column t)
// by the FKT threads of named barrier id (this one number lane): the chain
// T = H_0 .. H_{NQ-1} and each column's dT/dq_t (product rule) step by step,
// every entry of every 4x4 product on its own thread.  buf holds 2 FK_BUF
// floats.  Writes ee[0..3) and J[r NQ + t].
__device__ void fk_pair(const float* m, const float* s, const float* c,
                        int lane, int id, float* buf, float* ee, float* J) {
  float* cur = buf;
  float* nxt = buf + FK_BUF;
  map_entries<FK_BUF, FKT>(lane, [&](int e) {
    const int t = e / 16 - 1, ent = e % 16;
    return t < 0 ? hmat_e(m, 0, s[0], c[0], ent)
                 : (t == 0 ? hmat_d_e(m, 0, s[0], c[0], ent) : 0.f);
  }, [&](int e, float v) { cur[e] = v; });
  for (int j = 1; j < NQ; ++j) {
    named_sync(id, FKT);
    map_entries<FK_BUF, FKT>(lane, [&](int e) {
      const int t = e / 16 - 1, ent = e % 16, i = ent / 4, l = ent % 4;
      const float* A = cur + (t + 1) * 16;
      float acc = 0.f, acc2 = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc += A[i * 4 + jj] * hmat_e(m, j, s[j], c[j], jj * 4 + l);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc2 += cur[i * 4 + jj] * hmat_d_e(m, j, s[j], c[j], jj * 4 + l);
      return t == j ? acc + acc2 : acc;
    }, [&](int e, float v) { nxt[e] = v; });
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  named_sync(id, FKT);
  if (const int e = lane; e < 3 * (NQ + 1)) {
    const int r = e / (NQ + 1), t = e % (NQ + 1) - 1;
    const float val = cur[(t + 1) * 16 + r * 4 + 3];
    if (t < 0) ee[r] = val;
    else J[r * NQ + t] = val;
  }
}

// Gauss-Jordan without pivoting on the n x m augmented matrix aug by one
// knot's group (gj_block's arithmetic: piv = row_i / a_ii; A -= A[:, i] piv;
// row_i = piv), group barrier gsync().  piv needs m floats, fcol n.
template <int n, int m, class Sync>
__device__ inline void gj_group(float* aug, float* piv, float* fcol, int gl,
                                Sync gsync) {
  static_assert(n <= m, "augmented matrix");
  for (int i = 0; i < n; ++i) {
    gsync();
    map_entries<m, KT>(gl, [&](int c) {
      return F2{div_rn(aug[i * m + c], aug[i * m + i]), c < n ? aug[c * m + i] : 0.f};
    }, [&](int c, F2 v) {
      piv[c] = v.a;
      if (c < n) fcol[c] = v.b;
    });
    gsync();
    map_entries<n * m, KT>(gl, [&](int e) {
      const int r = e / m, c = e - r * m;
      const float p = piv[c];
      const float upd = aug[e] - fcol[r] * p;
      return r == i ? p : upd;
    }, [&](int e, float v) { aug[e] = v; });
  }
  gsync();
}

// integrate()'s step for joint j
__device__ inline void integrate_joint(const float* q, const float* qd,
                                       const float* qdd, float dt,
                                       int integrator_type, int wrap, int j,
                                       float* xn) {
  const float qdn = qd[j] + dt * qdd[j];
  const float qn = integrator_type == 0 ? q[j] + dt * qd[j] : q[j] + dt * qdn;
  xn[j] = wrap ? angle_wrap(qn) : qn;
  xn[NQ + j] = qdn;
}

struct KktArgs {
  const float* xu;         // this instance's rows
  int xu_stride;
  const float* goal;
  int goal_stride;
  const float* xs;
  const float* bm;         // K9a's flags or nullptr
  float dt, gravity, qd_cost, r_cost, rho;
  int N, integrator_type, wrap, terminal_at_last;
  float *Q_o, *A_o, *B_o, *q_o, *c_o;   // this instance's outputs
};

// Stage 1 for knot k by group gi (thread gl of KT): the linearization and
// the cost, and (kSchur) what the Schur rows read into slot; global outputs
// if own.
template <bool kSchur>
__device__ void knot_stage(const KktArgs& g, const float* sm, int k, bool own,
                           float* w, float* slot, int gl, int gi) {
  const auto gsync = [gi]() { named_sync(1 + gi, KT); };
  const int wg = gl >> 5, lane = gl & 31;
  const float* xu = g.xu;
  const int N = g.N;
  float* x = w + WS_X0;
  float* u = w + WS_U;
  float* xe = w + WS_XE;
  float* goal3 = w + WS_GL;
  float* sq = w + WS_SC;
  float* cq = sq + NQ;
  float* se = cq + NQ;
  float* ce = se + NQ;
  float* X = w + WS_X;
  float* Xp = w + WS_XP;
  float* IC = w + WS_IC;
  float* t36 = w + WS_T36;
  float* aug = w + WS_AUG;
  float* Minv = w + WS_MINV;
  float* cbias = w + WS_CB;
  float* qdd = w + WS_QDD;
  float* dID = w + WS_DID;
  float* dqdd = w + WS_DQDD;
  float* A = w + WS_A;
  float* B = w + WS_B;
  float* Qi = w + WS_QIW;
  float* grad = w + WS_GRAD;
  float* xn = w + WS_XN;
  float* ee = w + WS_EE;
  float* J = w + WS_J;
  const bool last = last_knot(g.bm, N, k);
  // the reference's terminal quirk: the last knot's cost at x_{N-2}
  const int ke = (last && !g.terminal_at_last && k > 0) ? k - 1 : k;
  if (gl < NX) {
    x[gl] = xu[k * g.xu_stride + gl];
    xe[gl] = xu[ke * g.xu_stride + gl];
  }
  if (gl < NU) u[gl] = xu[k * g.xu_stride + NX + gl];
  if (gl < 3) goal3[gl] = g.goal[k * g.goal_stride + gl];
  gsync();
  if (gl < NQ) {
    sq[gl] = sinf(x[gl]);
    cq[gl] = cosf(x[gl]);
    se[gl] = sinf(xe[gl]);
    ce[gl] = cosf(xe[gl]);
  }
  gsync();
  map_entries<NQ * M66, KT>(gl, [&](int e) {
    const int j = e / M66;
    const float s = sq[j], c = cq[j];
    const float b = sm[OFF_XS + e], d = sm[OFF_XCOS + e];
    return F3{sm[OFF_XC + e] + s * b + c * d, c * b - s * d, sm[OFF_I + e]};
  }, [&](int e, F3 v) {
    X[e] = v.a;
    Xp[e] = v.b;
    IC[e] = v.c;
  });
  // CRBA composite inertias: IC_{j-1} += X_j^T IC_j X_j
  for (int j = NQ - 1; j > 0; --j) {
    gsync();
    map_entries<M66, KT>(gl, [&](int e) {
      const int r = e / 6, c = e % 6;
      float acc = 0.f;
#pragma unroll
      for (int l = 0; l < 6; ++l) acc += X[j * M66 + l * 6 + r] * IC[j * M66 + l * 6 + c];
      return acc;
    }, [&](int e, float v) { t36[e] = v; });
    gsync();
    map_entries<M66, KT>(gl, [&](int e) {
      const int r = e / 6, c = e % 6;
      float acc = 0.f;
#pragma unroll
      for (int l = 0; l < 6; ++l) acc += t36[r * 6 + l] * X[j * M66 + l * 6 + c];
      return IC[(j - 1) * M66 + e] + acc;
    }, [&](int e, float v) { IC[(j - 1) * M66 + e] = v; });
  }
  gsync();
  // column j of M: M[i][j] = e_z^T X_{i+1}^T .. X_j^T IC_j e_z for i <= j,
  // thread j running i = j - 1 .. 0 in order (predicated, so in registers)
  if (gl < NQ) {
    const int j = gl;
    float v[6], mij[NQ];
#pragma unroll
    for (int i = 0; i < 6; ++i) v[i] = IC[j * M66 + i * 6 + 2];
    const float mjj = v[2];
#pragma unroll
    for (int i = NQ - 2; i >= 0; --i) {
      if (i < j) {
        float wv[6];
        mv6t(X + (i + 1) * M66, v, wv);
#pragma unroll
        for (int l = 0; l < 6; ++l) v[l] = wv[l];
      }
      mij[i] = v[2];
    }
    aug[j * 2 * NQ + j] = mjj;
#pragma unroll
    for (int i = 0; i < NQ - 1; ++i)
      if (i < j) {
        aug[i * 2 * NQ + j] = mij[i];
        aug[j * 2 * NQ + i] = mij[i];
      }
#pragma unroll
    for (int i = 0; i < NQ; ++i) aug[j * 2 * NQ + NQ + i] = i == j ? 1.f : 0.f;
  }
  gj_group<NQ, 2 * NQ>(aug, w + WS_PIV, w + WS_FCOL, gl, gsync);
  map_entries<NQ * NQ, KT>(gl, [&](int e) {
    return aug[(e / NQ) * 2 * NQ + NQ + e % NQ];
  }, [&](int e, float v) { Minv[e] = v; });
  // the bias term on warp 0 (every team runs it, team 0 writes it) and the
  // ee Jacobian at x_eval on the other warps, side by side
  if (wg == 0) {
    const int tm = lane / 6, c = lane - 6 * tm;
    rnea_team(X, Xp, sm + OFF_I, x + NQ, nullptr, -1, g.gravity, 6 * tm, c,
              tm == 0 ? cbias : nullptr, nullptr, 1);
  } else {
    fk_pair(sm, se, ce, gl - 32, 1 + KKT_MAX_GROUPS + gi, A, ee, J);
  }
  gsync();
  if (gl < NQ) {
    float acc = 0.f;
    for (int j = 0; j < NQ; ++j) acc += Minv[gl * NQ + j] * (u[j] - cbias[j]);
    float gr = 0.f;
    for (int r = 0; r < 3; ++r) gr += J[r * NQ + gl] * (ee[r] - goal3[r]);
    qdd[gl] = acc;
    grad[gl] = gr;
  } else if (gl < NX) {
    grad[gl] = g.qd_cost * xe[gl];
  }
  gsync();
  // dID/d{q, qd} at the solved qdd: the NX tangents on the group's 5 KW
  // teams of 6 lanes (5 per warp), at once; team tm of warp wg writes column
  // t = 5 wg + tm of dID (lanes 30, 31 and the teams past NX compute along
  // and write nothing)
  {
    const int tm = lane / 6, c = lane - 6 * tm;
    const int t = 5 * wg + tm;
    const bool real = tm < 5 && t < NX;
    rnea_team(X, Xp, sm + OFF_I, x + NQ, qdd, real ? t : -1, g.gravity, 6 * tm,
              c, nullptr, real ? dID + t : nullptr, NX);
  }
  gsync();
  map_entries<NQ * NX, KT>(gl, [&](int e) {
    const int i = e / NX, t = e - i * NX;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NQ; ++j) acc += Minv[i * NQ + j] * dID[j * NX + t];
    return -acc;
  }, [&](int e, float v) { dqdd[e] = v; });
  gsync();
  const float dt = g.dt;
  map_entries<NN, KT>(gl, [&](int e) {
    const int r = e / NX, c = e - r * NX;
    const float eye = r == c ? 1.f : 0.f;
    float val;
    if (r >= NQ) {
      const float dd = dqdd[(r - NQ) * NX + c];
      val = c < NQ ? dt * dd : eye + dt * dd;
    } else if (g.integrator_type == 0) {
      val = eye + (c == r + NQ ? dt : 0.f);
    } else {
      const float dd = dqdd[r * NX + c];
      val = c < NQ ? eye + dt * dt * dd : (c == r + NQ ? dt : 0.f) + dt * dt * dd;
    }
    return val;
  }, [&](int e, float v) { A[e] = v; });
  map_entries<NX * NU, KT>(gl, [&](int e) {
    const int r = e / NU, c = e - r * NU;
    if (r >= NQ) return dt * Minv[(r - NQ) * NQ + c];
    return g.integrator_type == 0 ? 0.f : dt * dt * Minv[r * NQ + c];
  }, [&](int e, float v) { B[e] = v; });
  if (gl < NQ) integrate_joint(x, x + NQ, qdd, dt, g.integrator_type, g.wrap, gl, xn);
  gsync();
  if constexpr (!kSchur) {
    FOR_STRIDED(e, gl, NN, KT) {
      const int r = e / NX, c = e - r * NX;
      float val = 0.f;
      if (r < NQ && c < NQ) val = grad[r] * grad[c];
      else if (r == c && r >= NQ) val = g.qd_cost;
      g.Q_o[(size_t)k * NN + e] = val;
      g.A_o[(size_t)k * NN + e] = k < N - 1 ? A[e] : 0.f;
    }
    FOR_STRIDED(e, gl, NX * NU, KT)
      g.B_o[(size_t)k * NX * NU + e] = k < N - 1 ? B[e] : 0.f;
    if (gl < NX) {
      g.q_o[k * NX + gl] = grad[gl];
      if (k < N - 1) g.c_o[(k + 1) * NX + gl] = xu[(k + 1) * g.xu_stride + gl] - xn[gl];
      if (k == 0) g.c_o[gl] = x[gl] - g.xs[gl];
    }
    return;
  }
  // (Q + rho I)^{-1} in closed form: Q = [[gq gq^T, 0], [0, qd_cost I]], so
  // (rho I + gq gq^T)^{-1} = (1/rho)(I - gq gq^T / (rho + |gq|^2))
  const float rho = g.rho;
  {
    float gq2 = 0.f;
    for (int i = 0; i < NQ; ++i) gq2 += grad[i] * grad[i];
    const float inv_rho = 1.f / rho;
    const float smc = inv_rho / (rho + gq2);
    const float s_qd = 1.f / (g.qd_cost + rho);
    map_entries<NN, KT>(gl, [&](int e) {
      const int r = e / NX, c = e - r * NX;
      float val = 0.f;
      if (r < NQ && c < NQ) val = (r == c ? inv_rho : 0.f) - smc * (grad[r] * grad[c]);
      else if (r == c) val = s_qd;
      return val;
    }, [&](int e, float v) {
      Qi[e] = v;
      slot[SL_QI + e] = v;
    });
  }
  gsync();
  float* AQ = slot + SL_AQ;
  map_entries<NN, KT>(gl, [&](int e) {
    const int r = e / NX, c = e - r * NX;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NX; ++j) acc += A[r * NX + j] * Qi[j * NX + c];
    return acc;
  }, [&](int e, float v) { AQ[e] = v; });
  gsync();
  const float s_r = 1.f / (g.r_cost + rho);
  map_entries<NN, KT>(gl, [&](int e) {
    const int r = e / NX, c = e - r * NX;
    float aqa = 0.f, bb = 0.f;
#pragma unroll
    for (int j = 0; j < NX; ++j) aqa += AQ[r * NX + j] * A[c * NX + j];
#pragma unroll
    for (int j = 0; j < NU; ++j) bb += B[r * NU + j] * B[c * NU + j];
    return F3{aqa + s_r * bb, Qi[e], A[e]};
  }, [&](int e, F3 v) {
    slot[SL_T + e] = v.a;
    if (own) {
      g.Q_o[(size_t)k * NN + e] = v.b;
      g.A_o[(size_t)k * NN + e] = last ? 0.f : v.c;
    }
  });
  if (own)
    FOR_STRIDED(e, gl, NX * NU, KT)
      g.B_o[(size_t)k * NX * NU + e] = last ? 0.f : B[e];
  if (gl < NX) {
    float aqq = 0.f, bu = 0.f;
    for (int j = 0; j < NX; ++j) aqq += AQ[gl * NX + j] * grad[j];
    for (int j = 0; j < NU; ++j) bu += B[gl * NU + j] * (g.r_cost * u[j]);
    const float xnl = xn[gl], gq = grad[gl];
    slot[SL_XN + gl] = xnl;
    slot[SL_AQQ + gl] = aqq;
    slot[SL_BRR + gl] = s_r * bu;
    slot[SL_Q + gl] = gq;
    if (own) g.q_o[k * NX + gl] = gq;
  }
}

// One launch of K1 / K8a / K9a (kSchur) or K5 (!kSchur): CTA blockIdx.x owns
// the window [s, e) = [x Kc, min(N, (x + 1) Kc)) of instance / shard
// blockIdx.y.  kSchur: Kc + 3 groups of KW warps, group i on knot s - 2 + i;
// !kSchur: Kc groups, group i on knot s + i.
template <bool kSchur>
__global__ void __launch_bounds__(KT * KKT_MAX_GROUPS)
kkt_window_kernel(const float* __restrict__ xu, int xu_stride, int xu_bstride,
                  const float* __restrict__ goal, int goal_stride,
                  int goal_bstride, const float* __restrict__ xs,
                  const float* __restrict__ rho_p, int rho_bstride,
                  const float* __restrict__ bmask, float dt,
                  const float* __restrict__ model, float gravity,
                  float qd_cost, float r_cost, int N, int Kc,
                  int integrator_type, int wrap, int terminal_at_last,
                  float* __restrict__ S, float* __restrict__ Pinv,
                  float* __restrict__ gamma, float* __restrict__ Q_o,
                  float* __restrict__ A_o, float* __restrict__ B_o,
                  float* __restrict__ q_o, float* __restrict__ c_o) {
  extern __shared__ __align__(16) float dsm[];
  const int gi = threadIdx.x / KT, gl = threadIdx.x - gi * KT;
  const int ngroups = blockDim.x / KT;
  const auto gsync = [gi]() { named_sync(1 + gi, KT); };
  const int b = blockIdx.y;
  const int s = blockIdx.x * Kc, e = min(s + Kc, N);
  const int halo = kSchur ? 2 : 0;
  float* sm = dsm;
  float* slots = dsm + MODEL_SIZE;
  float* ws = slots + (kSchur ? ngroups * SLOT_FLOATS : 0) + gi * WS_FLOATS;
  KktArgs g;
  g.xu = xu + (size_t)b * xu_bstride;
  g.xu_stride = xu_stride;
  g.goal = goal + (size_t)b * goal_bstride;
  g.goal_stride = goal_stride;
  g.xs = xs;
  g.bm = bmask != nullptr ? bmask + (size_t)b * 2 * N : nullptr;
  g.dt = dt;
  g.gravity = gravity;
  g.qd_cost = qd_cost;
  g.r_cost = r_cost;
  g.rho = kSchur ? rho_p[(size_t)b * rho_bstride] : 0.f;
  g.N = N;
  g.integrator_type = integrator_type;
  g.wrap = wrap;
  g.terminal_at_last = terminal_at_last;
  g.Q_o = Q_o + (size_t)b * N * NN;
  g.A_o = A_o + (size_t)b * N * NN;
  g.B_o = B_o + (size_t)b * N * NX * NU;
  g.q_o = q_o + (size_t)b * N * NX;
  g.c_o = c_o;
  load_model(sm, model);
  __syncthreads();
  // stage 1: knots s - halo .. e (kSchur) or s .. e - 1, one per group
  {
    const int k = s - halo + gi;
    const int k_end = kSchur ? min(e + 1, N) : e;
    if (k >= 0 && k < k_end)
      knot_stage<kSchur>(g, sm, k, k >= s && k < e, ws,
                         slots + gi * SLOT_FLOATS, gl, gi);
  }
  if constexpr (!kSchur) return;
  __syncthreads();
  const float* bm = g.bm;
  S += (size_t)b * N * 3 * NN;
  Pinv += (size_t)b * N * 3 * NN;
  gamma += (size_t)b * N * NX;
  xu = g.xu;
  // stage 2: slot i = gi + 1, knot s - 1 + gi, up to knot e
  {
    const int i = gi + 1, k = s - 2 + i;
    if (i < ngroups && k >= 0 && k <= e && k < N) {
      const bool has_prev = !first_knot(bm, k), has_next = !last_knot(bm, N, k);
      const bool own = k < e && k >= s;
      const float* prev = slots + (i - 1) * SLOT_FLOATS;   // valid if has_prev
      float* cur = slots + i * SLOT_FLOATS;
      const float* Qk = cur + SL_QI;
      float* aug = ws;
      float* Sk = S + (size_t)k * 3 * NN;
      map_entries<NN, KT>(gl, [&](int en) {
        const int r = en / NX, c = en - r * NX;
        const float theta = has_prev ? Qk[en] + prev[SL_T + en] : Qk[en];
        return F3{theta, has_prev ? -prev[SL_AQ + en] : 0.f,
                  has_next ? -cur[SL_AQ + c * NX + r] : 0.f};
      }, [&](int en, F3 v) {
        const int r = en / NX, c = en - r * NX;
        if (own) {
          Sk[en] = v.b;              // phi_k
          Sk[NN + en] = v.a;
          Sk[2 * NN + en] = v.c;     // phi_{k+1}^T
        }
        aug[r * 2 * NX + c] = v.a;
        aug[r * 2 * NX + NX + c] = r == c ? 1.f : 0.f;
      });
      if (own && gl < NX) {
        float gm = 0.f;
#pragma unroll
        for (int j = 0; j < NX; ++j) gm += Qk[gl * NX + j] * cur[SL_Q + j];
        if (has_prev) {
          const float ck = xu[k * xu_stride + gl] - prev[SL_XN + gl];
          gm = ((gm - ck) - prev[SL_AQQ + gl]) - prev[SL_BRR + gl];
        }
        gamma[k * NX + gl] = gm;
      }
      gj_group<NX, 2 * NX>(aug, aug + NX * 2 * NX, aug + NX * 2 * NX + 2 * NX, gl,
                           gsync);
      map_entries<NN, KT>(gl, [&](int en) {
        const int r = en / NX, c = en - r * NX;
        return aug[r * 2 * NX + NX + c];
      }, [&](int en, float d) {
        cur[SL_D + en] = d;
        if (own) Pinv[(size_t)k * 3 * NN + NN + en] = d;
      });
    }
  }
  __syncthreads();
  // stage 3: the own slots i = gi + 2, knot s + gi < e
  {
    const int i = gi + 2, k = s + gi;
    if (k < e) {
      const bool has_prev = !first_knot(bm, k), has_next = !last_knot(bm, N, k);
      const float* prev = slots + (i - 1) * SLOT_FLOATS;
      const float* cur = slots + i * SLOT_FLOATS;
      const float* Dk = cur + SL_D;
      float* tl = ws;
      float* tr = ws + NN;
      map_entries<NN, KT>(gl, [&](int en) {
        const int r = en / NX, c = en - r * NX;
        float al = 0.f, ar = 0.f;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const float phi = has_prev ? -prev[SL_AQ + j * NX + c] : 0.f;
          const float phit = has_next ? -cur[SL_AQ + c * NX + j] : 0.f;
          al += Dk[r * NX + j] * phi;
          ar += Dk[r * NX + j] * phit;
        }
        return F2{al, ar};
      }, [&](int en, F2 v) {
        tl[en] = v.a;
        tr[en] = v.b;
      });
      gsync();
      float* Pk = Pinv + (size_t)k * 3 * NN;
      FOR_STRIDED(en, gl, NN, KT) {
        const int r = en / NX, c = en - r * NX;
        float left = 0.f, right = 0.f;
        if (has_prev) {
          const float* Dm = prev + SL_D;
#pragma unroll
          for (int j = 0; j < NX; ++j) left += tl[r * NX + j] * Dm[j * NX + c];
          left = -left;
        }
        if (has_next) {
          const float* Dp = cur + SLOT_FLOATS + SL_D;
#pragma unroll
          for (int j = 0; j < NX; ++j) right += tr[r * NX + j] * Dp[j * NX + c];
          right = -right;
        }
        Pk[en] = left;
        Pk[2 * NN + en] = right;
      }
    }
  }
}

// knot groups of a CTA for windows of Kc knots, and the check of the
// caller's shared-memory size against the kernel's own count
int window_config(int Kc, int smem, bool schur, int* groups) {
  *groups = schur ? Kc + 3 : Kc;
  if (Kc < 1 || *groups > KKT_MAX_GROUPS ||
      smem != static_cast<int>(sizeof(float)) * kkt_smem_floats(*groups, schur))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <bool kSchur>
int launch_window(int N, int batch, int Kc, int smem, cudaStream_t st,
                  const float* xu, int xu_stride, int xu_bstride,
                  const float* goal, int goal_stride, int goal_bstride,
                  const float* xs, const float* rho, int rho_bstride,
                  const float* bmask, float dt, const float* model,
                  float gravity, float qd_cost, float r_cost,
                  int integrator_type, int wrap, int terminal_at_last,
                  float* S, float* Pinv, float* gamma, float* Q, float* A,
                  float* B, float* q, float* c) {
  int groups = 0;
  const int bad = window_config(Kc, smem, kSchur, &groups);
  if (bad != 0) return bad;
  // the attribute is the kernel's on each device; set it when a launch
  // needs more
  static int smem_set[64] = {};
  int device = 0;
  cudaGetDevice(&device);
  int& have = smem_set[device & 63];
  if (smem > have) {
    const cudaError_t err = cudaFuncSetAttribute(
        kkt_window_kernel<kSchur>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    have = smem;
  }
  const dim3 grid((N + Kc - 1) / Kc, batch);
  kkt_window_kernel<kSchur><<<grid, KT * groups, smem, st>>>(
      xu, xu_stride, xu_bstride, goal, goal_stride, goal_bstride, xs, rho,
      rho_bstride, bmask, dt, model, gravity, qd_cost, r_cost, N, Kc,
      integrator_type, wrap, terminal_at_last, S, Pinv, gamma, Q, A, B, q, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// batch instances side by side (K8a; K1 is batch = 1): instance b reads
// xu + b xu_bstride, goal + b goal_bstride, rho[b] and writes the b-th
// (N, ...) slab of every output; windows of Kc knots, smem bytes of dynamic
// shared memory (solver/kkt_cuda.py::kkt_window_plan)
extern "C" int kkt_schur_launch(
    const float* xu, int xu_stride, int xu_bstride, const float* goal,
    int goal_stride, int goal_bstride, const float* rho, float dt,
    const float* model, float gravity, float qd_cost, float r_cost, int N,
    int batch, int Kc, int smem, int integrator_type, int wrap,
    int terminal_at_last, float* S, float* Pinv, float* gamma, float* Qinv,
    float* A, float* B, float* q, void* stream) {
  return launch_window<true>(
      N, batch, Kc, smem, static_cast<cudaStream_t>(stream), xu, xu_stride,
      xu_bstride, goal, goal_stride, goal_bstride, nullptr, rho, 1, nullptr,
      dt, model, gravity, qd_cost, r_cost, integrator_type, wrap,
      terminal_at_last, S, Pinv, gamma, Qinv, A, B, q, nullptr);
}

// K9a: shards side by side, each a horizon of Lext knots: shard b reads
// rows b Lext .. of xu (rows of NX + NU) and of the goal (rows of
// goal_stride), its flags bmask + 2 Lext b and the one rho, and writes the
// b-th (Lext, ...) slab of every output; K1's windows of Lext knots
extern "C" int kkt_schur_slab_launch(
    const float* xu, const float* goal, int goal_stride, const float* bmask,
    const float* rho, float dt, const float* model, float gravity,
    float qd_cost, float r_cost, int Lext, int n_shard, int Kc, int smem,
    int integrator_type, int wrap, int terminal_at_last, float* S,
    float* Pinv, float* gamma, float* Qinv, float* A, float* B, float* q,
    void* stream) {
  return launch_window<true>(
      Lext, n_shard, Kc, smem, static_cast<cudaStream_t>(stream), xu, W,
      Lext * W, goal, goal_stride, Lext * goal_stride, nullptr, rho, 0, bmask,
      dt, model, gravity, qd_cost, r_cost, integrator_type, wrap,
      terminal_at_last, S, Pinv, gamma, Qinv, A, B, q, nullptr);
}

// K5: windows of Kc knots, one group of KW warps per knot, no halo
extern "C" int kkt_launch(const float* xu, int xu_stride, const float* goal,
                          int goal_stride, const float* xs, float dt,
                          const float* model, float gravity, float qd_cost,
                          int N, int Kc, int smem, int integrator_type,
                          int wrap, int terminal_at_last, float* Q, float* A,
                          float* B, float* q, float* c, void* stream) {
  return launch_window<false>(
      N, 1, Kc, smem, static_cast<cudaStream_t>(stream), xu, xu_stride, 0,
      goal, goal_stride, 0, xs, nullptr, 0, nullptr, dt, model, gravity,
      qd_cost, 0.f, integrator_type, wrap, terminal_at_last, nullptr, nullptr,
      nullptr, Q, A, B, q, c);
}
