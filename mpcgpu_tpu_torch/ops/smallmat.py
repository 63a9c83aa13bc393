"""Batched small-matrix inverse/solve by unrolled Gauss-Jordan elimination.

Port of ``mpcgpu_tpu/ops/smallmat.py``: no pivoting (the rho-regularized SPD
blocks of this solver do not need it), unrolled over the tiny static matrix
dimension, batched over leading dimensions.  Kept instead of
``torch.linalg.inv`` because it is the reference's arithmetic.
"""

from __future__ import annotations

import torch


def gj_solve_aug(M, rhs):
    """Solve M X = rhs; M (..., n, n), rhs (..., n, m) -> (..., n, m)."""
    n = M.shape[-1]
    A = torch.cat([M, rhs], dim=-1)
    for i in range(n):
        piv = A[..., i : i + 1, :] / A[..., i : i + 1, i : i + 1]
        A = A - A[..., :, i : i + 1] * piv
        A = torch.cat([A[..., :i, :], piv, A[..., i + 1 :, :]], dim=-2)
    return A[..., n:]


def gj_inverse(M):
    """Batched inverse of small SPD matrices: (..., n, n) -> (..., n, n)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    return gj_solve_aug(M, eye)


def gj_solve_vec(M, b):
    """Solve M x = b for M (..., n, n) and b (..., n)."""
    return gj_solve_aug(M, b[..., None])[..., 0]
