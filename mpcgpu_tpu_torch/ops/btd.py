"""Symmetric block-banded matrix storage and ops (port of mpcgpu_tpu/ops/btd.py).

``S`` has shape (N, 2b+1, n, n): slot b+d of row k holds block (k, k+d), zero
where k+d falls outside 0..N-1.  The block-tridiagonal case (b = 1) is

  S[k, 0] = block (k, k-1)   (zero for k = 0)
  S[k, 1] = block (k, k)
  S[k, 2] = block (k, k+1)   (zero for k = N-1)
"""

from __future__ import annotations

import torch


def btd_matvec(S, x):
    """y = S @ x for block-banded S (N, 2b+1, n, n) and block vector x (N, n)."""
    half = S.shape[1] // 2
    y = torch.einsum("kij,kj->ki", S[:, half], x)
    for d in range(1, half + 1):
        lo = torch.einsum("kij,kj->ki", S[d:, half - d], x[:-d])   # (k, k-d)
        hi = torch.einsum("kij,kj->ki", S[:-d, half + d], x[d:])   # (k, k+d)
        y = y + torch.cat([torch.zeros_like(lo[:d]), lo])
        y = y + torch.cat([hi, torch.zeros_like(hi[:d])])
    return y


def btd_to_dense(S):
    """Densify a block-tridiagonal S (N, 3, n, n) -> (N*n, N*n)."""
    N, _, n, _ = S.shape
    out = torch.zeros((N * n, N * n), dtype=S.dtype, device=S.device)
    for k in range(N):
        out[k * n : (k + 1) * n, k * n : (k + 1) * n] = S[k, 1]
        if k > 0:
            out[k * n : (k + 1) * n, (k - 1) * n : k * n] = S[k, 0]
        if k < N - 1:
            out[k * n : (k + 1) * n, (k + 1) * n : (k + 2) * n] = S[k, 2]
    return out
