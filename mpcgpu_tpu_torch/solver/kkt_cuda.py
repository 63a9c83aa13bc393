"""K1 (KKT assembly + Schur condensation + stair preconditioner in one call),
K5 (the KKT blocks alone) and K9a (K1 on the knot shards' halo-extended
slabs).

Ports of ``mpcgpu_tpu/solver/kkt_pallas.py::build_kkt_schur_pallas``,
``build_kkt_pallas`` and ``build_kkt_schur_pallas_slab``; the CUDA kernels
are in ``csrc/kkt_schur.cu``.  K1's outputs are knot-leading:

  S, Pinv (N, 3, nx, nx); gamma (N, nx); Qinv, A (N, nx, nx); B (N, nx, nu);
  q (N, nx)

A and B at the last knot are not part of the QP and are zero.  K9a's are the
same with a leading shard axis, (n_shard, Lext, ...).  K5 returns the
``KKTBlocks`` of the plain ``build_kkt``.  ``build_kkt_schur``,
``build_kkt_cuda`` and ``build_kkt_schur_slab`` run their plain versions for
CPU tensors and their kernels for CUDA tensors.

Each kernel is one launch of windows of consecutive knots per CTA, a
group of ``kkt_group_warps(nq)`` warps per knot slot (K1, K8a, K9a: with two
halo knots on the left and one on the right; K5: none).  K1, K5 and K9a (N
= the shard's Lext) take ``kkt_window_plan(N).window``, a fixed function of
N, and a group per slot.  K8a (``parallel/batched_cuda.py``) takes
``kkt_batched_plan``: where the batch fills the card, long windows whose
groups take the slots in turn, so that the halo knots cost less; each
instance's rows are K1's bit for bit under either plan.  Each launch takes
the library built for the model's nq (2..7).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.ops.schur import form_schur_system
from mpcgpu_tpu_torch.ops.smallmat import gj_inverse
from mpcgpu_tpu_torch.solver.kkt import (KKTBlocks, build_kkt,
                                         euler_step_and_jacobians,
                                         tracking_cost_grad_hess)

# the most knot groups a CTA takes (two named barriers each)
KKT_MAX_GROUPS = 7
# the knots a CTA owns (halo knots aside), for every N
KKT_WINDOW = 4
# K9a's slab: a shard of up to MAX_KNOTS knots and two halo knots per side
# (the kernel holds nothing sized by the knot count)
K9A_MAX_KNOTS = _kernels.MAX_KNOTS + 4


def kkt_group_warps(nq: int = 7) -> int:
    """KW of csrc/kkt_schur.cu: the warps of a knot group, 5 teams of 6
    lanes each, one team per tangent direction of the 2 nq (3 at nq = 6, 7;
    2 below)."""
    return 2 + (2 * nq > 10)


def kkt_slot_floats(nq: int = 7) -> int:
    """SLOT_FLOATS: a knot's slot (T, A Qinv, Qinv, D; xnext, A Qinv q,
    B Rinv r, q)."""
    nx = 2 * nq
    return 4 * nx * nx + 4 * nx


def kkt_ws_floats(nq: int = 7) -> int:
    """WS_FLOATS: one knot group's working set of the knot stage (the WS_*
    layout of csrc/kkt_schur.cu)."""
    nx = 2 * nq
    nn = nx * nx
    # A and B, or the FK chain's ping-pong buffers where those need more
    ab = max(nn + nx * nq, 2 * 16 * (nq + 1))
    return (3 * nq * 36 + 36                  # X, dX/dq, composite inertias, t36
            + 2 * nq * nq + 2 * nq + nq        # [M | I], piv, fcol
            + nq * nq + 2 * nq                 # Minv, bias, qdd
            + 2 * nq * nx + ab + nn            # dID, dqdd, A B, (Q + rho I)^-1
            + 2 * nx + 3 + 3 * nq              # grad, xnext, ee, J
            + 2 * nx + nq + 3 + 4 * nq)        # x, u, x_eval, goal, sin / cos


# the nq = 7 sizes, in floats: the packed model, a knot's slot and one knot
# group's working set
_MODEL_FLOATS = _kernels.model_floats(7)
_SLOT_FLOATS = kkt_slot_floats(7)
_WS_FLOATS = kkt_ws_floats(7)


class KKTPlan(NamedTuple):
    window: int       # Kc: the knots a CTA owns
    ctas: int         # ceil(N / Kc) per instance or shard
    smem_bytes: int   # dynamic shared memory of a K1 / K9a CTA


class KKTBatchedPlan(NamedTuple):
    window: int       # Kc: the knots a CTA owns
    groups: int       # G: knot groups a CTA, taking the Kc + 3 slots in turn
    ctas: int         # ceil(N / Kc) per instance
    smem_bytes: int   # dynamic shared memory of a K8a CTA


# one CTA's dynamic shared memory at most on an H100 (227 KB)
SMEM_LIMIT = 232_448


def kkt_smem_bytes(window: int, schur: bool = True, nq: int = 7,
                   groups: int | None = None) -> int:
    """Dynamic shared memory of one CTA (``kkt_smem_floats`` of
    csrc/kkt_schur.cu): the model, with the Schur stages (K1 / K8a / K9a)
    window + 3 knot slots, and a working set per knot group (default: one
    per slot, window + 3, or window for K5)."""
    if groups is None:
        groups = window + 3 if schur else window
    return 4 * (_kernels.model_floats(nq)
                + ((window + 3) * kkt_slot_floats(nq) if schur else 0)
                + groups * kkt_ws_floats(nq))


def kkt_window_plan(N: int, max_knots: int = _kernels.MAX_KNOTS,
                    nq: int = 7) -> KKTPlan:
    """The windows K1, K5, K8a and K9a launch for N knots: Kc = min(N,
    KKT_WINDOW) knots per CTA, ceil(N / Kc) CTAs.  A fixed function of N, so
    every caller cuts the horizon, and rounds, alike.  N runs from 2 to
    ``max_knots`` (K9a's halo-extended slabs: K9A_MAX_KNOTS); nq sets the
    shared memory."""
    if not 2 <= N <= max_knots:
        raise ValueError(f"N = {N} knots; the CUDA kernels take 2 <= N <= {max_knots}")
    window = min(N, KKT_WINDOW)
    return KKTPlan(window, -(-N // window), kkt_smem_bytes(window, nq=nq))


def kkt_knot_stages(N: int, window: int) -> int:
    """The knot stages (stage 1) one instance's launch runs over N knots in
    windows of ``window``: each window's own knots, two halo knots on the
    left and one on the right, those inside the horizon (N + 3 ceil(N /
    window) less the halo past its ends)."""
    return sum(min(N, s + window + 1) - max(0, s - 2) for s in range(0, N, window))


def kkt_batched_plan(N: int, B: int, nq: int, sms: int,
                     ctas_per_sm: Callable[[int, int], int]) -> KKTBatchedPlan:
    """K8a's windows for B instances of N knots on a card of ``sms`` SMs
    that holds ``ctas_per_sm(groups, smem_bytes)`` CTAs an SM at once (the
    card's occupancy, ``kkt_window_occupancy``).

    Among windows Kc from K1's (``kkt_window_plan(N).window``) to N, with G
    = min(KKT_MAX_GROUPS, Kc + 3) groups and shared memory within
    SMEM_LIMIT, the Kc of the fewest waves x rounds: waves = ceil(B ceil(N
    / Kc) / (sms x CTAs an SM)), rounds = ceil((Kc + 3) / G), the turns the
    groups take over the slots of stage 1 (the most of the three stages'
    ceil((Kc + 3) / G), ceil((Kc + 2) / G), ceil(Kc / G)); a tie goes to
    the smaller Kc.  A batch whose K1 windows fit in one wave keeps them
    (one round, the least halo of any one-wave plan)."""
    k1 = kkt_window_plan(N, nq=nq).window
    best = None
    for Kc in range(k1, N + 1):
        groups = min(KKT_MAX_GROUPS, Kc + 3)
        smem = kkt_smem_bytes(Kc, nq=nq, groups=groups)
        if smem > SMEM_LIMIT:
            break
        ctas = -(-N // Kc)
        per_sm = ctas_per_sm(groups, smem)
        if per_sm < 1:
            continue
        cost = -(-B * ctas // (sms * per_sm)) * -(-(Kc + 3) // groups)
        if best is None or cost < best[0]:
            best = cost, KKTBatchedPlan(Kc, groups, ctas, smem)
    if best is None:
        raise ValueError(f"no K8a window fits the card at N = {N}, nq = {nq}")
    return best[1]


def kkt_window_occupancy(groups: int, smem_bytes: int, nq: int, device) -> tuple:
    """(registers a thread, local bytes a thread, CTAs an SM) of K8a's
    kernel built for nq on the card ``device``, for CTAs of ``groups`` knot
    groups and ``smem_bytes`` of dynamic shared memory
    (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes

    out = (ctypes.c_int * 3)()
    fn = _kernels.entry("kkt_schur.cu", "kkt_window_occupancy", nq)
    with torch.cuda.device(device):
        _kernels.check(fn(groups, smem_bytes, out), "kkt_window_occupancy")
    return tuple(out)


def _check_args(cost: CostConfig, integrator_type: int) -> None:
    if cost.mode != "ee":
        raise ValueError("the KKT kernels support ee cost mode only")
    if integrator_type not in (0, 1):
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")


def _require_inputs(model: RobotModel, xu, ee_goal):
    """Check the kernel inputs of K1 and K5; returns the packed model."""
    _kernels.require_nq(model.nq)
    dev = xu.device
    N = xu.shape[0]
    _kernels.require_knots(N)
    _kernels.require(xu, "xu", (N, 3 * model.nq), dev)
    _kernels.require(ee_goal[:, :3], "ee_goal[:, :3]", (N, 3), dev,
                     row_major=True)
    packed = model.packed()
    _kernels.require(packed, "model", (packed.numel(),), dev)
    return packed


def build_kkt_schur_plain(model: RobotModel, cost: CostConfig, xu, xs, ee_goal,
                          rho, dt, integrator_type: int = 0,
                          angle_wrap: bool = False) -> dict:
    """``build_kkt`` + ``form_schur_system(preconditioner="stair")``,
    repacked into the kernel's outputs (Qinv by Gauss-Jordan)."""
    kkt = build_kkt(model, cost, xu, xs, ee_goal, dt, integrator_type,
                    angle_wrap)
    sch = form_schur_system(kkt, rho, preconditioner="stair")
    return dict(S=sch.S, Pinv=sch.Pinv, gamma=sch.gamma, Qinv=sch.Qinv,
                A=torch.cat([kkt.A, torch.zeros_like(kkt.A[:1])]),
                B=torch.cat([kkt.B, torch.zeros_like(kkt.B[:1])]),
                q=kkt.q)


def build_kkt_schur(model: RobotModel, cost: CostConfig, xu, xs, ee_goal, rho,
                    dt: float, integrator_type: int = 0,
                    angle_wrap: bool = False) -> dict:
    """KKT blocks -> (S, Pinv, gamma) and the dz inputs (Qinv, A, B, q).

    ee cost mode only: the kernel inverts Q + rho I in the closed form
    (Sherman-Morrison) that holds for the ee Gauss-Newton Hessian.  xs is
    unused by the outputs (gamma_0 leaves out c_0) and kept for the plain
    version's signature.  rho may be a float or a 0-d tensor.
    """
    _check_args(cost, integrator_type)
    if _kernels.on_cpu(xu):
        return build_kkt_schur_plain(model, cost, xu, xs, ee_goal, rho, dt,
                                     integrator_type, angle_wrap)
    dev = xu.device
    N = xu.shape[0]
    nq = model.nq
    nx = 2 * nq
    packed = _require_inputs(model, xu, ee_goal)
    rho_t = _kernels.scalar(rho, dev)

    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(S=torch.empty((N, 3, nx, nx), **f32),
               Pinv=torch.empty((N, 3, nx, nx), **f32),
               gamma=torch.empty((N, nx), **f32),
               Qinv=torch.empty((N, nx, nx), **f32),
               A=torch.empty((N, nx, nx), **f32),
               B=torch.empty((N, nx, nq), **f32),
               q=torch.empty((N, nx), **f32))
    plan = kkt_window_plan(N, nq=nq)
    _kernels.launch(
        dev, "kkt_schur.cu", "kkt_schur_launch", nq,
        xu.data_ptr(), xu.stride(0), 0, ee_goal.data_ptr(), ee_goal.stride(0),
        0, rho_t.data_ptr(), float(dt), packed.data_ptr(), float(model.gravity),
        float(cost.qd_cost), float(cost.r_cost), N, 1, plan.window,
        plan.smem_bytes, integrator_type, int(angle_wrap),
        int(cost.terminal_at_last_state), out["S"].data_ptr(),
        out["Pinv"].data_ptr(), out["gamma"].data_ptr(), out["Qinv"].data_ptr(),
        out["A"].data_ptr(), out["B"].data_ptr(), out["q"].data_ptr())
    build_kkt_schur.launches += 1
    return out


build_kkt_schur.launches = 0


def build_kkt_cuda(model: RobotModel, cost: CostConfig, xu, xs, ee_goal, dt: float,
                   integrator_type: int = 0, angle_wrap: bool = False) -> KKTBlocks:
    """K5: the KKT blocks of ``build_kkt`` (ee cost mode) in one launch
    (K1's windows, no halo).

    Q (N, nx, nx), q (N, nx), A (N-1, nx, nx), B (N-1, nx, nu) and c (N, nx)
    come from the kernel; R = r_cost I and r = r_cost u[:-1] are formed here
    as ``build_kkt`` forms them.  The plain version is ``build_kkt``.
    """
    _check_args(cost, integrator_type)
    if _kernels.on_cpu(xu):
        return build_kkt(model, cost, xu, xs, ee_goal, dt, integrator_type,
                         angle_wrap)
    dev = xu.device
    N = xu.shape[0]
    nq = model.nq
    nx = 2 * nq
    packed = _require_inputs(model, xu, ee_goal)
    _kernels.require(xs, "xs", (nx,), dev)

    f32 = dict(dtype=torch.float32, device=dev)
    Q = torch.empty((N, nx, nx), **f32)
    q = torch.empty((N, nx), **f32)
    A = torch.empty((N, nx, nx), **f32)
    B = torch.empty((N, nx, nq), **f32)
    c = torch.empty((N, nx), **f32)
    window = kkt_window_plan(N, nq=nq).window
    _kernels.launch(
        dev, "kkt_schur.cu", "kkt_launch", nq,
        xu.data_ptr(), xu.stride(0), ee_goal.data_ptr(), ee_goal.stride(0),
        xs.data_ptr(), float(dt), packed.data_ptr(), float(model.gravity),
        float(cost.qd_cost), N, window, kkt_smem_bytes(window, schur=False, nq=nq),
        integrator_type, int(angle_wrap),
        int(cost.terminal_at_last_state), Q.data_ptr(), A.data_ptr(),
        B.data_ptr(), q.data_ptr(), c.data_ptr())
    build_kkt_cuda.launches += 1
    u = xu[:-1, nx:]
    R = (cost.r_cost * torch.eye(nq, **f32)).expand(N - 1, nq, nq)
    return KKTBlocks(Q=Q, q=q, R=R, r=cost.r_cost * u, A=A[:-1], B=B[:-1], c=c)


build_kkt_cuda.launches = 0


def _shift(t, axis: int):
    """t moved one knot along ``axis`` (knot k gets knot k-1; zeros at 0)."""
    return torch.cat([torch.zeros_like(t.narrow(axis, 0, 1)),
                      t.narrow(axis, 0, t.shape[axis] - 1)], dim=axis)


def build_kkt_schur_slab_plain(model: RobotModel, cost: CostConfig, xu_ext,
                               ee_ext, first_mask, last_mask, rho, dt,
                               integrator_type: int = 0,
                               angle_wrap: bool = False) -> dict:
    """K9a's plain version, in the kernel's order: per knot the KKT blocks
    (``euler_step_and_jacobians``, ``tracking_cost_grad_hess``) and Qinv by
    Gauss-Jordan, then the Schur blocks and the stair bands from the
    neighbours in the window, where a knot at a window's end or with its
    global first / last flag has no neighbour on that side."""
    nx = 2 * model.nq
    Lext = xu_ext.shape[-2]
    lane = torch.arange(Lext, device=xu_ext.device)
    has_prev = (first_mask == 0) & (lane > 0)
    has_next = (last_mask == 0) & (lane < Lext - 1)
    x, u = xu_ext[..., :nx], xu_ext[..., nx:]
    xnext, A, B = euler_step_and_jacobians(model, x, u, dt, integrator_type,
                                           wrap=angle_wrap)
    x_eval = x
    if not cost.terminal_at_last_state:
        # the reference's terminal quirk: the last knot's cost at x_{N-2}
        x_prev = torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
        x_eval = torch.where(~has_next[..., None], x_prev, x)
    Q, q, R, r = tracking_cost_grad_hess(model, cost, x_eval, u, ee_ext)
    rho = torch.as_tensor(rho, dtype=Q.dtype, device=Q.device)
    eye = lambda m: torch.eye(m, dtype=Q.dtype, device=Q.device)
    Qinv = gj_inverse(Q + rho * eye(nx))
    Rinv = gj_inverse(R + rho * eye(R.shape[-1]))
    AQ = A @ Qinv
    BR = B @ Rinv
    T = AQ @ A.transpose(-1, -2) + BR @ B.transpose(-1, -2)
    hp3, hn3 = has_prev[..., None, None], has_next[..., None, None]
    hp2 = has_prev[..., None]
    zero = torch.zeros_like(Qinv)
    theta = torch.where(hp3, Qinv + _shift(T, -3), Qinv)
    phi = torch.where(hp3, -_shift(AQ, -3), zero)
    phiT = torch.where(hn3, -AQ.transpose(-1, -2), zero)
    g = torch.einsum("...ij,...j->...i", Qinv, q)
    c = x - _shift(xnext, -2)
    aqq = torch.einsum("...ij,...j->...i", AQ, q)
    brr = torch.einsum("...ij,...j->...i", BR, r)
    gamma = torch.where(hp2, ((g - c) - _shift(aqq, -2)) - _shift(brr, -2), g)
    D = gj_inverse(theta)
    left = torch.where(hp3, -((D @ phi) @ _shift(D, -3)), zero)
    D_next = torch.cat([D[..., 1:, :, :], torch.zeros_like(D[..., :1, :, :])], -3)
    right = torch.where(hn3, -((D @ phiT) @ D_next), zero)
    last3 = ~hn3
    return dict(S=torch.stack([phi, theta, phiT], dim=-3),
                Pinv=torch.stack([left, D, right], dim=-3), gamma=gamma,
                Qinv=Qinv, A=torch.where(last3, torch.zeros_like(A), A),
                B=torch.where(last3, torch.zeros_like(B), B), q=q)


def build_kkt_schur_slab(model: RobotModel, cost: CostConfig, xu_ext, ee_ext,
                         first_mask, last_mask, rho, dt: float,
                         integrator_type: int = 0,
                         angle_wrap: bool = False) -> dict:
    """K9a: K1 on n_shard windows of the horizon at once.

    xu_ext (n_shard, Lext, nx+nu), ee_ext (n_shard, Lext, 6): each shard's
    knots with two halo knots per side; first_mask, last_mask (n_shard,
    Lext): nonzero at the GLOBAL first / last knot.  Returns K1's outputs
    per window, (n_shard, Lext, ...); a window's interior rows are the
    horizon's rows (the caller drops the halo knots).  ee cost mode only;
    rho may be a float or a 0-d tensor.  ``angle_wrap`` reflects the
    integrated joint angles at +-pi (``solver/kkt.py::angle_wrap``), which
    moves the defects and so gamma, as in K1.
    """
    _check_args(cost, integrator_type)
    if _kernels.on_cpu(xu_ext):
        return build_kkt_schur_slab_plain(model, cost, xu_ext, ee_ext,
                                          first_mask, last_mask, rho, dt,
                                          integrator_type, angle_wrap)
    nq = model.nq
    _kernels.require_nq(nq)
    dev = xu_ext.device
    n_shard, Lext = xu_ext.shape[:2]
    plan = kkt_window_plan(Lext, K9A_MAX_KNOTS, nq)
    nx = 2 * nq
    _kernels.require(xu_ext, "xu_ext", (n_shard, Lext, 3 * nq), dev)
    _kernels.require(ee_ext, "ee_ext", (n_shard, Lext, ee_ext.shape[-1]), dev)
    packed = model.packed()
    _kernels.require(packed, "model", (packed.numel(),), dev)
    bmask = torch.stack([first_mask, last_mask], dim=1).to(torch.float32)
    rho_t = _kernels.scalar(rho, dev)

    f32 = dict(dtype=torch.float32, device=dev)
    lead = (n_shard, Lext)
    out = dict(S=torch.empty(lead + (3, nx, nx), **f32),
               Pinv=torch.empty(lead + (3, nx, nx), **f32),
               gamma=torch.empty(lead + (nx,), **f32),
               Qinv=torch.empty(lead + (nx, nx), **f32),
               A=torch.empty(lead + (nx, nx), **f32),
               B=torch.empty(lead + (nx, nq), **f32),
               q=torch.empty(lead + (nx,), **f32))
    _kernels.launch(
        dev, "kkt_schur.cu", "kkt_schur_slab_launch", nq,
        xu_ext.data_ptr(), ee_ext.data_ptr(), ee_ext.stride(1), bmask.data_ptr(),
        rho_t.data_ptr(), float(dt), packed.data_ptr(), float(model.gravity),
        float(cost.qd_cost), float(cost.r_cost), Lext, n_shard, plan.window,
        plan.smem_bytes, integrator_type, int(angle_wrap),
        int(cost.terminal_at_last_state),
        out["S"].data_ptr(), out["Pinv"].data_ptr(), out["gamma"].data_ptr(),
        out["Qinv"].data_ptr(), out["A"].data_ptr(), out["B"].data_ptr(),
        out["q"].data_ptr())
    build_kkt_schur_slab.launches += 1
    return out


build_kkt_schur_slab.launches = 0
