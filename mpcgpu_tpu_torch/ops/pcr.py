"""Parallel cyclic reduction (PCR): exact direct solve of block-tridiagonal
systems in ceil(log2 N) data-parallel levels.

Port of ``mpcgpu_tpu/ops/pcr.py``.  Level update (s = 2^l; the terms of
neighbours k-s < 0 and k+s >= N are absent):

    x_{k-s} = th_{k-s}^{-1} (b_{k-s} - L_{k-s} x_{k-2s} - U_{k-s} x_k)
    x_{k+s} = th_{k+s}^{-1} (b_{k+s} - L_{k+s} x_k - U_{k+s} x_{k+2s})

substituted into row k gives the next-level coefficients

    L'  = -L_k A_{k-s},            A = th^{-1} L     (0 where k-2s < 0)
    U'  = -U_k B_{k+s},            B = th^{-1} U     (0 where k+2s >= N)
    th' = th_k - L_k B_{k-s} - U_k A_{k+s}
    b'  = b_k - L_k v_{k-s} - U_k v_{k+s},    v = th^{-1} b

and after ceil(log2 N) levels all rows are decoupled: x = th^{-1} b.  The
JAX package takes the neighbours with ``jnp.roll`` and relies on the zeroed
L/U rows to annihilate what wraps around; here the bounds on k+-s are
explicit, so a non-power-of-two N needs no padding.

``pcr_solve_refined`` is the plain version of kernel K7
(``ops/pcr_cuda.py``) and follows its order: the factors (th^{-1}, L, U) of
every level are computed once, and each refinement pass only sweeps a new
right-hand side through them (the JAX XLA function refactors S in its
refinement solve; the JAX Pallas kernel reuses the factors as here).
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch.ops.btd import btd_matvec
from mpcgpu_tpu_torch.ops.smallmat import gj_inverse


def pcr_levels(N: int) -> int:
    """ceil(log2 N) for N >= 2, 0 for N = 1."""
    return (N - 1).bit_length()


def pcr_factor(S):
    """The per-level factors of the SPD BTD S (N, 3, n, n).

    Returns (factors, thinv_f): factors[l] = (th^{-1}, L, U) of level l, each
    (N, n, n), and thinv_f the inverse of the decoupled diagonal blocks."""
    N = S.shape[0]
    L = S[:, 0].clone()
    U = S[:, 2].clone()
    th = S[:, 1]
    L[0] = 0.0                      # structural zeros on the corner blocks
    U[N - 1] = 0.0
    factors = []
    for lvl in range(pcr_levels(N)):
        s = 1 << lvl
        thinv = gj_inverse(th)
        factors.append((thinv, L, U))
        A = thinv @ L
        B = thinv @ U
        th_new = th.clone()
        th_new[s:] = th[s:] - L[s:] @ B[:N - s]
        th_new[:N - s] = th_new[:N - s] - U[:N - s] @ A[s:]
        L_new = torch.zeros_like(L)
        U_new = torch.zeros_like(U)
        m = max(N - 2 * s, 0)               # rows whose k+-2s neighbour exists
        L_new[N - m:] = -(L[N - m:] @ A[s:s + m])
        U_new[:m] = -(U[:m] @ B[s:s + m])
        L, U, th = L_new, U_new, th_new
    return factors, gj_inverse(th)


def pcr_sweep(factors, thinv_f, b):
    """x = th_f^{-1} b' with b' the right-hand side b (N, n) carried through
    every level: b' = b - L_k v_{k-s} - U_k v_{k+s}, v = th^{-1} b."""
    N = b.shape[0]
    for lvl, (thinv, L, U) in enumerate(factors):
        s = 1 << lvl
        v = (thinv @ b[..., None])[..., 0]
        b = b.clone()
        b[s:] = b[s:] - (L[s:] @ v[:N - s, :, None])[..., 0]
        b[:N - s] = b[:N - s] - (U[:N - s] @ v[s:, :, None])[..., 0]
    return (thinv_f @ b[..., None])[..., 0]


def pcr_solve(S, b):
    """Solve the SPD BTD system S x = b exactly (up to rounding).

    S (N, 3, n, n): S[k,0] = block (k,k-1), S[k,1] = diagonal, S[k,2] =
    block (k,k+1) (the layout of ops/schur.py); b (N, n).  Returns x (N, n).
    """
    return pcr_sweep(*pcr_factor(S), b)


def pcr_solve_refined(S, b, refine: int = 1):
    """PCR solve + ``refine`` passes of iterative refinement
    (r = b - S x; x += PCR(r) through the stored factors).

    The Schur systems here are ill-conditioned (cond ~ 1e5-1e6 after
    regularization), so one f32 PCR pass loses most digits; refinement
    recovers a solution whose true residual beats the capped stair PCG."""
    factors, thinv_f = pcr_factor(S)
    x = pcr_sweep(factors, thinv_f, b)
    for _ in range(refine):
        x = x + pcr_sweep(factors, thinv_f, b - btd_matvec(S, x))
    return x
