// Device helpers shared by the kernels of mpcgpu_tpu_torch (f32, IIWA-sized
// serial chains: NQ = 7 revolute-z joints).
//
// Spatial algebra follows Featherstone's [angular; linear] convention, as
// mpcgpu_tpu/models/spatial.py does.  Matrices are row-major.  The model is
// one packed vector (RobotModel.packed()):
//   [xc | xs | xcos | inertia] each NQ x 6 x 6, then [hc | hs | hcos] each
//   NQ x 4 x 4, with the joint transforms affine in (sin q, cos q):
//   X_j(q) = xc_j + sin(q_j) xs_j + cos(q_j) xcos_j   (and likewise 4x4).
#pragma once

#include <cuda_runtime.h>

namespace mpc {

constexpr int NQ = 7;
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
constexpr int MODEL_SIZE = OFF_HCOS + NQ * 16;   // 1344 floats
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

// Articulated-body forward dynamics (Featherstone RBDA Table 7.1), one
// sample per thread: the same recursion as
// mpcgpu_tpu_torch/models/dynamics.py::forward_dynamics_aba.
__device__ inline void aba(const float* m, const float* s, const float* c,
                           const float* qd, const float* u, float gravity,
                           float* qdd) {
  float cb[NQ][6], pA[NQ][6], U[NQ][6], d[NQ], uu[NQ];
  float X[M66], v[6], vp[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float* I = m + OFF_I;
  for (int j = 0; j < NQ; ++j) {
    xmat(m, j, s[j], c[j], X);
    mv6(X, vp, v);
    v[2] += qd[j];
    for (int i = 0; i < 6; ++i) cb[j][i] = 0.f;
    cross_ez_add(v, qd[j], cb[j]);
    float Iv[6];
    mv6(I + j * M66, v, Iv);
    for (int i = 0; i < 6; ++i) pA[j][i] = 0.f;
    crf_add(v, Iv, pA[j]);
    for (int i = 0; i < 6; ++i) vp[i] = v[i];
  }
  float IA[M66], Ia[M66], IaX[M66];
  for (int e = 0; e < M66; ++e) IA[e] = I[(NQ - 1) * M66 + e];
  for (int j = NQ - 1; j >= 0; --j) {
    for (int i = 0; i < 6; ++i) U[j][i] = IA[i * 6 + 2];
    d[j] = IA[2 * 6 + 2];
    uu[j] = u[j] - pA[j][2];
    if (j > 0) {
      for (int a = 0; a < 6; ++a)
        for (int b = 0; b < 6; ++b)
          Ia[a * 6 + b] = IA[a * 6 + b] - U[j][a] * U[j][b] / d[j];
      float pa[6], t[6];
      mv6(Ia, cb[j], t);
      float ud = uu[j] / d[j];
      for (int i = 0; i < 6; ++i) pa[i] = pA[j][i] + t[i] + U[j][i] * ud;
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
      for (int i = 0; i < 6; ++i) pA[j - 1][i] += t[i];
    }
  }
  float ap[6], apar[6] = {0.f, 0.f, 0.f, 0.f, 0.f, gravity};
  for (int j = 0; j < NQ; ++j) {
    xmat(m, j, s[j], c[j], X);
    mv6(X, apar, ap);
    float dot = 0.f;
    for (int i = 0; i < 6; ++i) {
      ap[i] += cb[j][i];
      dot += U[j][i] * ap[i];
    }
    qdd[j] = (uu[j] - dot) / d[j];
    for (int i = 0; i < 6; ++i) apar[i] = ap[i];
    apar[2] += qdd[j];
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
