"""Rigid-body dynamics of a serial chain of revolute-z joints, plain PyTorch.

Featherstone's conventions (spatial vectors [angular; linear], joint k's
parent is k - 1, zero gravity as in the MPCGPU plant).  Every function takes
states with any leading dimensions.  Inverse dynamics is the recursive
Newton-Euler algorithm; the mass matrix is its columns ID(q, 0, e_j);
forward dynamics solves M qdd = u - c(q, qd); derivatives are forward-mode
automatic differentiation of the same functions.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from portbench.reference import iiwa14_params as _p
from portbench.reference.arith import Arith


class Chain:
    """The IIWA-14's parameters as tensors of the arithmetic's dtype."""

    def __init__(self, ar: Arith, device):
        t = lambda a: torch.tensor(np.asarray(a), dtype=ar.dtype, device=device)
        self.ar = ar
        self.nq = _p.NQ
        self.xc, self.xs, self.xcos = t(_p.XC), t(_p.XS), t(_p.XCOS)
        self.inertia = t(_p.IMATS)
        self.hc, self.hs, self.hcos = t(_p.HOMC), t(_p.HOMS), t(_p.HOMCOS)
        self.ez = t([0, 0, 1, 0, 0, 0])


def _affine(c, s_, co, q):
    s = torch.sin(q)[..., None, None]
    cq = torch.cos(q)[..., None, None]
    return c + s * s_ + cq * co


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _crm_ez(v, s):
    """v x (e_z s) for motion vectors v (..., 6), s (...)."""
    z = torch.zeros_like(v[..., 0])
    return s[..., None] * torch.stack(
        [v[..., 1], -v[..., 0], z, v[..., 4], -v[..., 3], z], dim=-1)


def _crf(v, f):
    """v x* f for a motion vector v and a force vector f."""
    w, vo, fw, fv = v[..., :3], v[..., 3:], f[..., :3], f[..., 3:]
    return torch.cat([_cross(w, fw) + _cross(vo, fv), _cross(w, fv)], dim=-1)


def rnea(ch: Chain, q, qd, qdd):
    """Joint torques tau = ID(q, qd, qdd), (..., nq) each."""
    ar = ch.ar
    X = _affine(ch.xc, ch.xs, ch.xcos, q)
    v = torch.zeros(q.shape[:-1] + (6,), dtype=q.dtype, device=q.device)
    a = torch.zeros_like(v)
    forces = []
    for k in range(ch.nq):
        v = ar.mv(X[..., k, :, :], v) + ch.ez * qd[..., k:k + 1]
        a = (ar.mv(X[..., k, :, :], a) + _crm_ez(v, qd[..., k])
             + ch.ez * qdd[..., k:k + 1])
        I = ch.inertia[k]
        forces.append(ar.mv(I, a) + _crf(v, ar.mv(I, v)))
    tau = [None] * ch.nq
    f = forces[-1]
    for k in range(ch.nq - 1, -1, -1):
        tau[k] = f[..., 2]
        if k:
            f = forces[k - 1] + ar.mtv(X[..., k, :, :], f)
    return torch.stack(tau, dim=-1)


def mass_matrix(ch: Chain, q):
    """M(q) (..., nq, nq): column j is ID(q, 0, e_j) (no gravity, no
    velocity)."""
    nq = ch.nq
    eye = torch.eye(nq, dtype=q.dtype, device=q.device)
    qj = q[..., None, :].expand(q.shape[:-1] + (nq, nq))
    cols = rnea(ch, qj, torch.zeros_like(qj), eye.expand_as(qj))
    return cols.transpose(-1, -2)


def forward_dynamics(ch: Chain, q, qd, u):
    """qdd = M(q)^-1 (u - c(q, qd))."""
    c = rnea(ch, q, qd, torch.zeros_like(q))
    return torch.linalg.solve(mass_matrix(ch, q), (u - c)[..., None])[..., 0]


def _per_sample(fn, *args):
    """vmap a one-sample function over the flattened leading dims."""
    lead = args[0].shape[:-1]
    out = vmap(fn)(*(a.reshape(-1, a.shape[-1]) for a in args))
    return tuple(o.reshape(lead + o.shape[1:]) for o in out)


def fd_and_gradient(ch: Chain, q, qd, u):
    """(qdd, dqdd/dq, dqdd/dqd, M^-1): implicit differentiation of
    ID(q, qd, qdd) = u at the solved qdd."""
    minv = torch.linalg.inv(mass_matrix(ch, q))
    c = rnea(ch, q, qd, torch.zeros_like(q))
    qdd = ch.ar.mv(minv, u - c)
    d_q, d_qd = _per_sample(
        jacfwd(lambda a, b, cc: rnea(ch, a, b, cc), argnums=(0, 1)), q, qd, qdd)
    return qdd, -ch.ar.mm(minv, d_q), -ch.ar.mm(minv, d_qd), minv


def ee_xyz(ch: Chain, q):
    """End-effector position (..., 3): the product of the joints'
    homogeneous transforms applied to the origin."""
    H = _affine(ch.hc, ch.hs, ch.hcos, q)
    T = H[..., 0, :, :]
    for k in range(1, ch.nq):
        T = ch.ar.mm(T, H[..., k, :, :])
    return T[..., :3, 3]


def ee_xyz_and_jac(ch: Chain, q):
    """(ee (..., 3), d ee / dq (..., 3, nq))."""
    (jac,) = _per_sample(lambda qq: (jacfwd(lambda x: ee_xyz(ch, x))(qq),), q)
    return ee_xyz(ch, q), jac


def euler_step(ch: Chain, x, u, dt):
    """One explicit Euler step of the chain, x (..., 2 nq), u (..., nq)."""
    nq = ch.nq
    q, qd = x[..., :nq], x[..., nq:]
    qdd = forward_dynamics(ch, q, qd, u)
    return torch.cat([q + dt * qd, qd + dt * qdd], dim=-1)
