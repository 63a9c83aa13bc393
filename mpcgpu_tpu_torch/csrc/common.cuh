// Device helpers shared by the kernels of mpcgpu_tpu_torch (f32 serial
// chains of NQ revolute-z joints).  NQ is a compile-time value, the build's
// -DMPC_NQ=<nq> (_kernels.py builds one library per source and nq; 7, the
// IIWA's, without the flag); every size below follows from it.
//
// Spatial algebra follows Featherstone's [angular; linear] convention, as
// mpcgpu_tpu/models/spatial.py does.  Matrices are row-major.  The model is
// one packed vector (RobotModel.packed()):
//   [xc | xs | xcos | inertia] each NQ x 6 x 6, then [hc | hs | hcos] each
//   NQ x 4 x 4, with the joint transforms affine in (sin q, cos q):
//   X_j(q) = xc_j + sin(q_j) xs_j + cos(q_j) xcos_j   (and likewise 4x4).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mpc {

#ifndef MPC_NQ
constexpr int MPC_NQ = 7;
#endif
constexpr int NQ = MPC_NQ;
constexpr int NX = 2 * NQ;
constexpr int NU = NQ;
constexpr int W = NX + NU;                 // one knot's row of xu / dz
constexpr int M66 = 36;
constexpr int OFF_XC = 0;
constexpr int OFF_XS = NQ * M66;
constexpr int OFF_XCOS = 2 * NQ * M66;
constexpr int OFF_I = 3 * NQ * M66;
constexpr int OFF_HC = 4 * NQ * M66;
constexpr int OFF_HS = OFF_HC + NQ * 16;
constexpr int OFF_HCOS = OFF_HS + NQ * 16;
constexpr int MODEL_SIZE = OFF_HCOS + NQ * 16;   // 192 NQ floats (1344 at 7)
constexpr int DYN_SIZE = OFF_HC;   // the part dynamics reads: X and inertias

// the first n floats of the packed model (all of it by default)
__device__ inline void load_model(float* dst, const float* src,
                                  int n = MODEL_SIZE) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// X_j = xc + s xs + c xcos (6x6)
__device__ inline void xmat(const float* m, int j, float s, float c, float* X) {
  const float* a = m + OFF_XC + j * M66;
  const float* b = m + OFF_XS + j * M66;
  const float* d = m + OFF_XCOS + j * M66;
  for (int e = 0; e < M66; ++e) X[e] = a[e] + s * b[e] + c * d[e];
}

// 4x4 homogeneous transform of joint j and its derivative in q_j
__device__ inline void hmat(const float* m, int j, float s, float c, float* H) {
  const float* a = m + OFF_HC + j * 16;
  const float* b = m + OFF_HS + j * 16;
  const float* d = m + OFF_HCOS + j * 16;
  for (int e = 0; e < 16; ++e) H[e] = a[e] + s * b[e] + c * d[e];
}

__device__ inline void hmat_d(const float* m, int j, float s, float c, float* H) {
  const float* b = m + OFF_HS + j * 16;
  const float* d = m + OFF_HCOS + j * 16;
  for (int e = 0; e < 16; ++e) H[e] = c * b[e] - s * d[e];
}

// out = M v (6x6)
__device__ inline void mv6(const float* M, const float* v, float* out) {
  for (int i = 0; i < 6; ++i) {
    float acc = 0.f;
    for (int j = 0; j < 6; ++j) acc += M[i * 6 + j] * v[j];
    out[i] = acc;
  }
}

// out = M^T v (6x6)
__device__ inline void mv6t(const float* M, const float* v, float* out) {
  for (int i = 0; i < 6; ++i) {
    float acc = 0.f;
    for (int j = 0; j < 6; ++j) acc += M[j * 6 + i] * v[j];
    out[i] = acc;
  }
}

// out = A B (4x4)
__device__ inline void mm4(const float* A, const float* B, float* out) {
  for (int i = 0; i < 4; ++i)
    for (int l = 0; l < 4; ++l) {
      float acc = 0.f;
      for (int j = 0; j < 4; ++j) acc += A[i * 4 + j] * B[j * 4 + l];
      out[i * 4 + l] = acc;
    }
}

__device__ inline void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// out += v x* f  (crf(v) f = [w x fw + vo x fv; w x fv])
__device__ inline void crf_add(const float* v, const float* f, float* out) {
  float t0[3], t1[3], t2[3];
  cross3(v, f, t0);
  cross3(v + 3, f + 3, t1);
  cross3(v, f + 3, t2);
  for (int i = 0; i < 3; ++i) {
    out[i] += t0[i] + t1[i];
    out[3 + i] += t2[i];
  }
}

// out += m x (e_z s) = s [m1, -m0, 0, m4, -m3, 0]
__device__ inline void cross_ez_add(const float* m, float s, float* out) {
  out[0] += s * m[1];
  out[1] += s * -m[0];
  out[3] += s * m[4];
  out[4] += s * -m[3];
}

// End-effector position by the homogeneous chain T = H_0 ... H_{NQ-1};
// s, c = sin/cos of the joint angles.
__device__ inline void fk_ee(const float* m, const float* s, const float* c,
                             float* ee) {
  float T[16], H[16], Tn[16];
  hmat(m, 0, s[0], c[0], T);
  for (int j = 1; j < NQ; ++j) {
    hmat(m, j, s[j], c[j], H);
    mm4(T, H, Tn);
    for (int e = 0; e < 16; ++e) T[e] = Tn[e];
  }
  ee[0] = T[3];
  ee[1] = T[7];
  ee[2] = T[11];
}

// a / b, correctly rounded.  A zero dividend over a finite nonzero divisor
// gives the signed zero the division gives, without the division's slow
// path (which a zero dividend takes, as a denormal one does).
__device__ inline float div_rn(float a, float b) {
  if (a == 0.f && b != 0.f && isfinite(b))
    return __int_as_float((__float_as_int(a) ^ __float_as_int(b)) & 0x80000000);
  return a / b;
}

// aba's per-link vectors, in floats of its vec
constexpr int ABA_CB = 0;                 // cb (NQ x 6)
constexpr int ABA_PA = ABA_CB + NQ * 6;   // pA
constexpr int ABA_U = ABA_PA + NQ * 6;    // U
constexpr int ABA_D = ABA_U + NQ * 6;     // d
constexpr int ABA_UU = ABA_D + NQ;        // uu
constexpr int ABA_VEC = ABA_UU + NQ;

// Articulated-body forward dynamics (Featherstone RBDA Table 7.1), one
// sample per thread (K3, K9c; the plant runs aba_warp below): the same
// recursion as mpcgpu_tpu_torch/models/dynamics.py::forward_dynamics_aba.
// The per-link vectors cb, pA, U, d, uu go to vec (ABA_VEC floats of the
// caller's memory, e.g. the thread's shared memory), the 6x6 matrices stay
// in registers.
__device__ inline void aba(const float* m, const float* s, const float* c,
                               const float* qd, const float* u, float gravity,
                               float* qdd, float* vec) {
  float* cb = vec + ABA_CB;
  float* pA = vec + ABA_PA;
  float* U = vec + ABA_U;
  float* d = vec + ABA_D;
  float* uu = vec + ABA_UU;
  float X[M66], v[6], vp[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float* I = m + OFF_I;
  for (int j = 0; j < NQ; ++j) {
    xmat(m, j, s[j], c[j], X);
    mv6(X, vp, v);
    v[2] += qd[j];
    float cbj[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    cross_ez_add(v, qd[j], cbj);
    float Iv[6];
    mv6(I + j * M66, v, Iv);
    float pAj[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    crf_add(v, Iv, pAj);
    for (int i = 0; i < 6; ++i) {
      cb[j * 6 + i] = cbj[i];
      pA[j * 6 + i] = pAj[i];
      vp[i] = v[i];
    }
  }
  float IA[M66], Ia[M66], IaX[M66];
  for (int e = 0; e < M66; ++e) IA[e] = I[(NQ - 1) * M66 + e];
  for (int j = NQ - 1; j >= 0; --j) {
    float Uj[6];
    for (int i = 0; i < 6; ++i) Uj[i] = IA[i * 6 + 2];
    const float dj = IA[2 * 6 + 2];
    const float uuj = u[j] - pA[j * 6 + 2];
    for (int i = 0; i < 6; ++i) U[j * 6 + i] = Uj[i];
    d[j] = dj;
    uu[j] = uuj;
    if (j > 0) {
      for (int a = 0; a < 6; ++a)
        for (int b = 0; b < 6; ++b)
          Ia[a * 6 + b] = IA[a * 6 + b] - div_rn(Uj[a] * Uj[b], dj);
      float pa[6], t[6], cbj[6];
      for (int i = 0; i < 6; ++i) cbj[i] = cb[j * 6 + i];
      mv6(Ia, cbj, t);
      float ud = div_rn(uuj, dj);
      for (int i = 0; i < 6; ++i) pa[i] = pA[j * 6 + i] + t[i] + Uj[i] * ud;
      xmat(m, j, s[j], c[j], X);
      for (int a = 0; a < 6; ++a)
        for (int b = 0; b < 6; ++b) {
          float acc = 0.f;
          for (int k = 0; k < 6; ++k) acc += Ia[a * 6 + k] * X[k * 6 + b];
          IaX[a * 6 + b] = acc;
        }
      const float* Ip = I + (j - 1) * M66;
      for (int a = 0; a < 6; ++a)
        for (int b = 0; b < 6; ++b) {
          float acc = 0.f;
          for (int k = 0; k < 6; ++k) acc += X[k * 6 + a] * IaX[k * 6 + b];
          IA[a * 6 + b] = Ip[a * 6 + b] + acc;
        }
      mv6t(X, pa, t);
      for (int i = 0; i < 6; ++i) pA[(j - 1) * 6 + i] += t[i];
    }
  }
  float ap[6], apar[6] = {0.f, 0.f, 0.f, 0.f, 0.f, gravity};
  for (int j = 0; j < NQ; ++j) {
    xmat(m, j, s[j], c[j], X);
    mv6(X, apar, ap);
    float dot = 0.f;
    for (int i = 0; i < 6; ++i) {
      ap[i] += cb[j * 6 + i];
      dot += U[j * 6 + i] * ap[i];
    }
    qdd[j] = div_rn(uu[j] - dot, d[j]);
    for (int i = 0; i < 6; ++i) apar[i] = ap[i];
    apar[2] += qdd[j];
  }
}

// Shared-memory workspace of aba_warp (one per warp).  aba_warp puts joint
// j's sin, cos, control and bias terms on lane j and the tip's inertia on
// the lanes past NQ.
static_assert(NQ >= 1 && NQ < 32, "aba_warp: one lane per joint, and one more");
struct AbaWarpWs {
  float sc[2 * NQ];            // sin q, cos q
  float X[NQ * M66];           // every joint's transform of this state
  float v[NQ * 6], cb[NQ * 6], pA[NQ * 6], U[NQ * 6];
  float dinv[NQ], uu[NQ];      // 1 / d and u - pA[2] of every link
  float IA[M66], IaX[M66], pa[6];
};

// component i of a x b (3-vectors)
__device__ inline float cross3_i(const float* a, const float* b, int i) {
  const int i1 = i == 2 ? 0 : i + 1, i2 = i == 0 ? 2 : i - 1;
  return a[i1] * b[i2] - a[i2] * b[i1];
}

// aba's recursion by one warp (all 32 lanes call).  q, qd in shared memory
// (NQ floats each), u_lane the control of joint `lane` (lanes < NQ); qdd
// (shared) written by lane 0.  Once per call, on all lanes: sin and cos,
// the NQ transforms X_j (36 NQ entries), and after the velocity chain the
// bias terms cb and pA of every link (one lane per link).  The velocity and
// acceleration chains run on lane 0 from registers (six independent 6-term
// sums per link).  Eliminating link j, tip to base, takes two steps over
// the lanes: Ia X (two entries of one row per lane) and pa, with Ia = IA -
// U (U / d)^T formed row by row where used (every lane forms 1 / d itself),
// then the parent's IA = I + X^T Ia X (21 entries of the symmetric matrix,
// each mirrored) and pA (6).  Deterministic: every entry is one lane's
// fixed-order sum.  The divisions by d are products with 1 / d, so its
// last bits differ from aba's.
__device__ inline void aba_warp(const float* m, const float* q,
                                const float* qd, float u_lane, float gravity,
                                float* qdd, AbaWarpWs& w) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const float* I = m + OFF_I;
  if (lane < NQ) {
    w.sc[lane] = sinf(q[lane]);
    w.sc[NQ + lane] = cosf(q[lane]);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < (NQ * M66 + 31) / 32; ++r) {
    const int e = lane + 32 * r;
    if (e < NQ * M66) {
      const int j = e / M66;
      w.X[e] = m[OFF_XC + e] + w.sc[j] * m[OFF_XS + e] + w.sc[NQ + j] * m[OFF_XCOS + e];
    }
  }
  __syncwarp();
  // velocities, base to tip, on lane 0: v_j = X_j v_{j-1} + e_z qd_j
  if (lane == 0) {
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float* Xj = w.X + j * M66;
      float vn[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float acc = 0.f;
        if (j > 0) {
#pragma unroll
          for (int k = 0; k < 6; ++k) acc += Xj[i * 6 + k] * v[k];
        }
        vn[i] = acc;
      }
      vn[2] += qd[j];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        v[i] = vn[i];
        w.v[j * 6 + i] = vn[i];
      }
    }
  }
  __syncwarp();
  // every link on its own lane: cb = v x (e_z qd) and pA = v x* (I v) =
  // [w x fw + vo x fv; w x fv]; the tip's IA = I on the other lanes
  if (lane < NQ) {
    const int j = lane;
    const float* vj = w.v + j * 6;
    const float* Ij = I + j * M66;
    const float s = qd[j];
    float v6[6], f[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) v6[k] = vj[k];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += Ij[a * 6 + k] * v6[k];
      f[a] = acc;
    }
    float* cb = w.cb + j * 6;
    cb[0] = s * v6[1];
    cb[1] = s * -v6[0];
    cb[2] = 0.f;
    cb[3] = s * v6[4];
    cb[4] = s * -v6[3];
    cb[5] = 0.f;
    float* pA = w.pA + j * 6;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pA[i] = cross3_i(v6, f, i) + cross3_i(v6 + 3, f + 3, i);
      pA[3 + i] = cross3_i(v6, f + 3, i);
    }
  } else {
    for (int e = lane - NQ; e < M66; e += 32 - NQ) w.IA[e] = I[(NQ - 1) * M66 + e];
  }
  __syncwarp();
  // articulated inertias, tip to base; this lane's upper-triangle entry
  // (lanes 0..20) or pA row (lanes 21..26) of the parent step
  int ta = 0, tb = lane;
  while (tb >= 6 - ta && ta < 6) {
    tb -= 6 - ta;
    ++ta;
  }
  tb += ta;
  const bool tri = lane < 21;
  if (!tri) {
    ta = lane - 21 < 6 ? lane - 21 : 0;
    tb = 0;
  }
  for (int j = NQ - 1; j >= 0; --j) {
    const float* Xj = w.X + j * M66;
    // this link's U = IA[:, 2], 1 / d, and uu = u_j - pA_j[2], on every lane
    const float dinv = __frcp_rn(w.IA[2 * 6 + 2]);
    const float uuj = __shfl_sync(full, u_lane, j) - w.pA[j * 6 + 2];
    if (lane < 6) w.U[j * 6 + lane] = w.IA[lane * 6 + 2];
    if (lane == 0) {
      w.dinv[j] = dinv;
      w.uu[j] = uuj;
    }
    if (j == 0) break;
    // Ia X and pa: lane 3a + c (< 18) forms row a of Ia = IA - U (U / d)^T
    // and the entries (a, c) and (a, c + 3) of Ia X; lane 18 + a forms row
    // a of Ia and pa[a] (one uniform instruction stream)
    if (lane < 24) {
      const bool ix = lane < 18;
      const int a = ix ? lane / 3 : lane - 18, c = ix ? lane - 3 * a : 0;
      const float* col0 = ix ? Xj + c : w.cb + j * 6;
      const float* col1 = ix ? Xj + c + 3 : w.cb + j * 6;
      const int stride = ix ? 6 : 1;
      const float ua = w.IA[a * 6 + 2];
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float ia = w.IA[a * 6 + k] - ua * (w.IA[k * 6 + 2] * dinv);
        acc0 += ia * col0[k * stride];
        acc1 += ia * col1[k * stride];
      }
      if (ix) {
        w.IaX[a * 6 + c] = acc0;
        w.IaX[a * 6 + c + 3] = acc1;
      } else {
        w.pa[a] = (w.pA[j * 6 + a] + acc0) + ua * (uuj * dinv);
      }
    }
    __syncwarp();
    // the parent's IA = I + X^T (Ia X) and pA += X^T pa
    if (lane < 27) {
      const float* vec = tri ? w.IaX + tb : w.pa;
      const int stride = tri ? 6 : 1;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += Xj[k * 6 + ta] * vec[k * stride];
      const float base = tri ? I[(j - 1) * M66 + ta * 6 + tb] : w.pA[(j - 1) * 6 + ta];
      const float val = base + acc;
      if (tri) {
        w.IA[ta * 6 + tb] = val;
        w.IA[tb * 6 + ta] = val;
      } else {
        w.pA[(j - 1) * 6 + ta] = val;
      }
    }
    __syncwarp();
  }
  __syncwarp();
  // accelerations, base to tip, on lane 0: a_j = X_j a_{j-1} + cb_j,
  // qdd_j = (uu_j - U_j . a_j) / d_j, a_j[2] += qdd_j
  if (lane == 0) {
    float a[6] = {0.f, 0.f, 0.f, 0.f, 0.f, gravity};
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float* Xj = w.X + j * M66;
      float ap[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) acc += Xj[i * 6 + k] * a[k];
        ap[i] = acc + w.cb[j * 6 + i];
      }
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) dot += w.U[j * 6 + i] * ap[i];
      const float qj = (w.uu[j] - dot) * w.dinv[j];
      qdd[j] = qj;
#pragma unroll
      for (int i = 0; i < 6; ++i) a[i] = ap[i];
      a[2] += qj;
    }
  }
  __syncwarp();
}

// Hopper's asynchronous remote stores: a 4-byte st.async into a CTA of the
// cluster completes its bytes on that CTA's mbarrier
__device__ inline uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ inline uint32_t cluster_u32(const void* ptr, int cta) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_u32(ptr)), "r"(cta));
  return out;
}

__device__ inline void st_async(uint32_t addr, float v, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
      :: "r"(addr), "r"(__float_as_uint(v)), "r"(mbar) : "memory");
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ inline void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of `bar` with this parity to complete.  A round
// that never completes (a fault of the kernel) traps after 2^26 polls, so
// the launch fails instead of hanging the card.
__device__ inline void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t ok = 0;
  for (uint32_t n = 0; !ok; ++n) {
    if (n == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(addr), "r"(parity) : "memory");
  }
}

// the 8-byte st.async (an f64) into a CTA of the cluster
__device__ inline void st_async64(uint32_t addr, double v, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n"
      :: "r"(addr), "l"(__double_as_longlong(v)), "r"(mbar) : "memory");
}

// The cluster barrier in two halves: every thread of every CTA arrives
// (releasing its prior writes to the cluster) and later waits (acquiring
// every CTA's), so work can go on between the two.
__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// an arrival that releases nothing: after fence.mbarrier_init, which
// releases the mbarrier initialisations to the cluster itself
__device__ inline void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// for (int e = first; e < n; e += stride) with compile-time n and stride,
// unrolled so that a lane's entries overlap
#define FOR_STRIDED(e, first, n, stride)                                   \
  _Pragma("unroll") for (int e##_r = 0; e##_r < ((n) + (stride) - 1) / (stride); \
                         ++e##_r)                                          \
    if (const int e = (first) + e##_r * (stride); e < (n))

// A thread's entries e = first, first + stride, ... < n of a map: every
// value f(e) is computed before the first put(e, value).  Buffers that share
// one shared-memory array cannot be told apart by the compiler, so a store
// inside the loop would make the next entry's loads wait for it; this way a
// thread's entries overlap.
template <int n, int stride, class F, class Put>
__device__ inline void map_entries(int first, F f, Put put) {
  constexpr int R = (n + stride - 1) / stride;
  using V = decltype(f(0));
  V val[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = first + r * stride;
    if (e < n) val[r] = f(e);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = first + r * stride;
    if (e < n) put(e, val[r]);
  }
}

// The reference's angleWrap: a reflection at +-3.14159.
__device__ inline float angle_wrap(float q) {
  const float pi = 3.14159f;
  if (q > pi) q = -(q - pi);
  if (q < -pi) q = -(q + pi);
  return q;
}

// One integrator step of the positions/velocities (0 = explicit Euler,
// 1 = semi-implicit Euler), written to xn (NX).
__device__ inline void integrate(const float* q, const float* qd,
                                 const float* qdd, float dt, int integrator_type,
                                 int wrap, float* xn) {
  for (int j = 0; j < NQ; ++j) {
    float qdn = qd[j] + dt * qdd[j];
    float qn = integrator_type == 0 ? q[j] + dt * qd[j] : q[j] + dt * qdn;
    xn[j] = wrap ? angle_wrap(qn) : qn;
    xn[NQ + j] = qdn;
  }
}

// Sum of v over the block, returned to every thread.  Fixed-order (warp
// shuffles, then the warp partials in warp order), so deterministic for a
// given block size.  red needs 33 floats of shared memory.
__device__ inline float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < nw ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// Gauss-Jordan elimination without pivoting on the shared n x m augmented
// matrix aug (m > n), by the whole block: on return columns n..m-1 hold
// M^{-1} rhs.  Same arithmetic as mpcgpu_tpu_torch/ops/smallmat.py
// (piv = row_i / a_ii; A -= A[:, i] piv; row_i = piv).  piv needs m floats
// and fcol n floats of shared memory.  Every thread of the block must call.
__device__ inline void gj_block(float* aug, int n, int m, float* piv,
                                float* fcol) {
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    for (int c = threadIdx.x; c < m; c += blockDim.x)
      piv[c] = aug[i * m + c] / aug[i * m + i];
    for (int r = threadIdx.x; r < n; r += blockDim.x) fcol[r] = aug[r * m + i];
    __syncthreads();
    for (int e = threadIdx.x; e < n * m; e += blockDim.x) {
      const int r = e / m, c = e - r * m;
      aug[e] = r == i ? piv[c] : aug[e] - fcol[r] * piv[c];
    }
  }
  __syncthreads();
}

}  // namespace mpc
