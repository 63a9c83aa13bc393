"""Spatial (Plücker) algebra, Featherstone convention [angular; linear].

Port of ``mpcgpu_tpu/models/spatial.py``; every function batches over
leading dimensions.
"""

from __future__ import annotations

import torch


def skew(w):
    """3-vector -> 3x3 cross-product matrix."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def crm(v):
    """Spatial motion cross operator: crm(v) @ m == v x m (6x6)."""
    wx = skew(v[..., 0:3])
    vx = skew(v[..., 3:6])
    zero = torch.zeros_like(wx)
    top = torch.cat([wx, zero], dim=-1)
    bot = torch.cat([vx, wx], dim=-1)
    return torch.cat([top, bot], dim=-2)


def crf(v):
    """Spatial force cross operator: crf(v) = -crm(v)^T."""
    return -crm(v).transpose(-1, -2)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def crm_apply(v, m):
    """v x m for motion vectors without forming the 6x6 operator."""
    w, vo = v[..., 0:3], v[..., 3:6]
    mw, mv = m[..., 0:3], m[..., 3:6]
    return torch.cat([_cross(w, mw), _cross(vo, mw) + _cross(w, mv)], dim=-1)


def crf_apply(v, f):
    """v x* f for force vectors: crf(v) @ f."""
    w, vo = v[..., 0:3], v[..., 3:6]
    fw, fv = f[..., 0:3], f[..., 3:6]
    return torch.cat([_cross(w, fw) + _cross(vo, fv), _cross(w, fv)], dim=-1)
