"""Direct block-tridiagonal LDL^T solver (the on-device qdldl equivalent).

Port of ``mpcgpu_tpu/ops/ldl.py``, which computes it in XLA with
``lax.scan`` over the knots; here it is a Python loop over the knots whose
steps are small batched solves (``torch.linalg.solve_ex``, which reads
nothing back to the host).  It is not a kernel's plain version.

Factorization of SPD BTD S (blocks theta_k diag, phi_k sub-diag):
    D_0 = theta_0
    L_k = phi_k D_{k-1}^{-1}            (k = 1..N-1)
    D_k = theta_k - L_k phi_k^T
solve via forward substitution, block solves with D_k, back substitution.
"""

from __future__ import annotations

import torch


def _solve(A, B):
    """A^{-1} B without the singularity check (which would synchronize)."""
    return torch.linalg.solve_ex(A, B).result


def btd_ldl_factor(S):
    """Factor BTD S (N,3,n,n) -> (D (N,n,n), L (N-1,n,n))."""
    theta = S[:, 1]
    phi = S[1:, 0]
    D, L = [theta[0]], []
    for k in range(1, S.shape[0]):
        Lk = _solve(D[-1].T, phi[k - 1].T).T        # phi_k D_{k-1}^{-1}
        D.append(theta[k] - Lk @ phi[k - 1].T)
        L.append(Lk)
    L = torch.stack(L) if L else S.new_zeros((0,) + S.shape[2:])
    return torch.stack(D), L


def btd_ldl_solve(S, b):
    """Direct solve S x = b for SPD BTD S (N,3,n,n), b (N,n); returns (N,n)."""
    D, L = btd_ldl_factor(S)
    N = S.shape[0]
    # forward: y_0 = b_0; y_k = b_k - L_k y_{k-1}
    y = [b[0]]
    for k in range(1, N):
        y.append(b[k] - L[k - 1] @ y[-1])
    # diagonal: w_k = D_k^{-1} y_k
    w = _solve(D, torch.stack(y)[..., None])[..., 0]
    # backward: x_{N-1} = w_{N-1}; x_k = w_k - L_{k+1}^T x_{k+1}
    x = [w[-1]]
    for k in range(N - 2, -1, -1):
        x.append(w[k] - L[k].T @ x[-1])
    return torch.stack(x[::-1])
