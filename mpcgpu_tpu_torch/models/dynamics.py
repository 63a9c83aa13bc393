"""Batched rigid-body dynamics: FK, RNEA, CRBA, forward dynamics and gradients.

Port of ``mpcgpu_tpu/models/dynamics.py``.  The JAX functions take one
sample and are vmapped by their callers; these take a state with any
leading batch dimensions (the solver passes the knot axis), e.g.
q (N, nq) -> qdd (N, nq).  Joint loops are unrolled in Python (nq is small
and static).  Joints are revolute-z (S = e_z); gravity enters as the base
spatial acceleration [0, 0, 0, 0, 0, g].
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.models.spatial import crf_apply
from mpcgpu_tpu_torch.ops.smallmat import gj_inverse, gj_solve_vec


def _unit(k: int, like: torch.Tensor) -> torch.Tensor:
    e = [0.0] * 6
    e[k] = 1.0
    return torch.tensor(e, dtype=like.dtype, device=like.device)


def _per_sample(fn, *args):
    """vmap a one-sample function over the flattened leading dims of args
    (each (..., d)); outputs get those leading dims back."""
    lead = args[0].shape[:-1]
    flat = [a.reshape(-1, a.shape[-1]) for a in args]
    out = vmap(fn)(*flat)
    if isinstance(out, tuple):
        return tuple(o.reshape(*lead, *o.shape[1:]) for o in out)
    return out.reshape(*lead, *out.shape[1:])


# ---------------------------------------------------------------------------
# forward kinematics
# ---------------------------------------------------------------------------


def fk_ee_hom(model: RobotModel, q):
    """Base -> end-effector homogeneous transform, (..., nq) -> (..., 4, 4):
    T = Xhom_0 @ Xhom_1 @ ... @ Xhom_{nq-1}."""
    H = model.hom_xmats(q)
    T = H[..., 0, :, :]
    for k in range(1, model.nq):
        T = T @ H[..., k, :, :]
    return T


def fk_ee_xyz(model: RobotModel, q):
    """End-effector position (..., 3)."""
    return fk_ee_hom(model, q)[..., 0:3, 3]


def fk_ee(model: RobotModel, q):
    """End-effector pose (..., 6) = [xyz, roll, pitch, yaw] (the RPY branch
    of the JAX package's ``fk_ee``)."""
    T = fk_ee_hom(model, q)
    roll = torch.atan2(T[..., 2, 1], T[..., 2, 2])
    pitch = -torch.atan2(T[..., 2, 0],
                         torch.sqrt(T[..., 2, 1] ** 2 + T[..., 2, 2] ** 2))
    yaw = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    return torch.cat([T[..., 0:3, 3], torch.stack([roll, pitch, yaw], -1)], -1)


def fk_ee_xyz_and_jac(model: RobotModel, q):
    """(ee_xyz (..., 3), d ee_xyz / dq (..., 3, nq)), the Jacobian by
    forward-mode AD through the same transform product."""
    jac = _per_sample(jacfwd(lambda qq: fk_ee_xyz(model, qq)), q)
    return fk_ee_xyz(model, q), jac


# ---------------------------------------------------------------------------
# inverse dynamics (RNEA)
# ---------------------------------------------------------------------------


def _cross_ez(m, s):
    """m x (e_z * s) for a revolute-z joint: s * [m1, -m0, 0, m4, -m3, 0]."""
    z = torch.zeros_like(m[..., 0])
    return s[..., None] * torch.stack(
        [m[..., 1], -m[..., 0], z, m[..., 4], -m[..., 3], z], dim=-1)


def rnea(model: RobotModel, q, qd, qdd=None):
    """Recursive Newton-Euler inverse dynamics tau = ID(q, qd, qdd); with
    qdd=None the bias term c(q, qd) = ID(q, qd, 0).  q, qd (..., nq)."""
    nq = model.nq
    X = model.xmats(q)
    I = model.inertia
    ez = _unit(2, q)
    a_base = _unit(5, q) * model.gravity
    zero6 = torch.zeros_like(a_base)
    va_prev = torch.stack([zero6, a_base], dim=-1)           # (6, 2)

    fs = []
    for k in range(nq):
        va = X[..., k, :, :] @ va_prev                        # (..., 6, 2)
        vk = va[..., :, 0] + ez * qd[..., k : k + 1]
        ak = va[..., :, 1] + _cross_ez(vk, qd[..., k])
        if qdd is not None:
            ak = ak + ez * qdd[..., k : k + 1]
        Iva = I[k] @ torch.stack([ak, vk], dim=-1)            # I a and I v
        fs.append(Iva[..., :, 0] + crf_apply(vk, Iva[..., :, 1]))
        va_prev = torch.stack([vk, ak], dim=-1)

    taus = [None] * nq
    f_carry = fs[nq - 1]
    for k in range(nq - 1, -1, -1):
        taus[k] = f_carry[..., 2]
        if k > 0:
            f_carry = fs[k - 1] + (
                X[..., k, :, :].transpose(-1, -2) @ f_carry[..., None])[..., 0]
    return torch.stack(taus, dim=-1)


# ---------------------------------------------------------------------------
# mass matrix and forward dynamics
# ---------------------------------------------------------------------------


def mass_matrix(model: RobotModel, q):
    """Joint-space inertia M(q) by the composite-rigid-body algorithm,
    (..., nq) -> (..., nq, nq)."""
    nq = model.nq
    X = model.xmats(q)
    Xt = X.transpose(-1, -2)
    IC = [model.inertia[k].expand(X.shape[:-3] + (6, 6)) for k in range(nq)]
    for k in range(nq - 1, 0, -1):
        IC[k - 1] = IC[k - 1] + Xt[..., k, :, :] @ IC[k] @ X[..., k, :, :]

    # all columns' spatial forces walk down together: column j's force
    # IC_j e_z is injected when the walk reaches frame j; row j of M is then
    # valid for columns k >= j (the upper triangle), mirrored at the end
    col = torch.arange(nq, device=q.device)
    F = torch.zeros(X.shape[:-3] + (6, nq), dtype=X.dtype, device=X.device)
    rows = [None] * nq
    for j in range(nq - 1, -1, -1):
        F = torch.where(col == j, IC[j][..., :, 2:3], F)
        rows[j] = F[..., 2, :]
        if j > 0:
            F = Xt[..., j, :, :] @ F
    M = torch.stack(rows, dim=-2)
    return torch.triu(M) + torch.triu(M, 1).transpose(-1, -2)


def minv(model: RobotModel, q):
    """Dense M(q)^{-1} by Gauss-Jordan."""
    return gj_inverse(mass_matrix(model, q))


def forward_dynamics(model: RobotModel, q, qd, u):
    """qdd = M(q)^{-1} (u - c(q, qd))."""
    c = rnea(model, q, qd)
    return gj_solve_vec(mass_matrix(model, q), u - c)


def forward_dynamics_aba(model: RobotModel, q, qd, u):
    """qdd by the articulated-body algorithm (Featherstone RBDA Table 7.1):
    the same qdd as ``forward_dynamics`` without forming or inverting M."""
    nq = model.nq
    X = model.xmats(q)
    Xt = X.transpose(-1, -2)
    I = model.inertia
    ez = _unit(2, q)

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    v_par = None
    vs, cs, pAs = [], [], []
    for k in range(nq):
        vk = ez * qd[..., k : k + 1]
        if v_par is not None:
            vk = mv(X[..., k, :, :], v_par) + vk
        cs.append(_cross_ez(vk, qd[..., k]))
        pAs.append(crf_apply(vk, mv(I[k], vk)))
        vs.append(vk)
        v_par = vk

    IA = [I[k].expand(X.shape[:-3] + (6, 6)) for k in range(nq)]
    pA = list(pAs)
    U, d, uu = [None] * nq, [None] * nq, [None] * nq
    for k in range(nq - 1, -1, -1):
        U[k] = IA[k][..., :, 2]
        d[k] = IA[k][..., 2, 2]
        uu[k] = u[..., k] - pA[k][..., 2]
        if k > 0:
            Ia = IA[k] - U[k][..., :, None] * U[k][..., None, :] / d[k][..., None, None]
            pa = pA[k] + mv(Ia, cs[k]) + U[k] * (uu[k] / d[k])[..., None]
            IA[k - 1] = IA[k - 1] + Xt[..., k, :, :] @ (Ia @ X[..., k, :, :])
            pA[k - 1] = pA[k - 1] + mv(Xt[..., k, :, :], pa)

    a_par = _unit(5, q) * model.gravity
    qdds = []
    for k in range(nq):
        ap = mv(X[..., k, :, :], a_par) + cs[k]
        qdd_k = (uu[k] - (U[k] * ap).sum(-1)) / d[k]
        qdds.append(qdd_k)
        a_par = ap + ez * qdd_k[..., None]
    return torch.stack(qdds, dim=-1)


def fd_and_gradient(model: RobotModel, q, qd, u):
    """(qdd, dqdd/dq, dqdd/dqd, dqdd/du = M^{-1}), each Jacobian (..., nq, nq).

    Implicit differentiation of RNEA(q, qd, qdd) = u at the solved qdd:
    dqdd/d{q,qd} = -M^{-1} dRNEA/d{q,qd} with qdd held fixed; the inner
    Jacobian is forward-mode AD of the same RNEA.
    """
    c = rnea(model, q, qd)
    minv_ = gj_inverse(mass_matrix(model, q))
    qdd = (minv_ @ (u - c)[..., None])[..., 0]
    did_dq, did_dqd = _per_sample(
        jacfwd(lambda qq, qqd, qqdd: rnea(model, qq, qqd, qqdd), argnums=(0, 1)),
        q, qd, qdd)
    return qdd, -minv_ @ did_dq, -minv_ @ did_dqd, minv_
