"""K1: KKT assembly + Schur condensation + stair preconditioner in one call.

Port of ``mpcgpu_tpu/solver/kkt_pallas.py::build_kkt_schur_pallas``; the
CUDA kernel is ``csrc/kkt_schur.cu``.  Outputs are knot-leading:

  S, Pinv (N, 3, nx, nx); gamma (N, nx); Qinv, A (N, nx, nx); B (N, nx, nu);
  q (N, nx)

A and B at the last knot are not part of the QP and are zero.
``build_kkt_schur`` runs the plain version for CPU tensors and the kernel
for CUDA tensors.
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.ops.schur import form_schur_system
from mpcgpu_tpu_torch.solver.kkt import build_kkt

# floats of per-knot scratch the kernel hands from launch A to launch B:
# T (nx^2), A Qinv (nx^2), xnext, A Qinv q, B Rinv r (nx each)
_SCRATCH_PER_KNOT = 2 * 14 * 14 + 3 * 14


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
    if cost.mode != "ee":
        raise ValueError("build_kkt_schur supports ee cost mode only")
    if integrator_type not in (0, 1):
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")
    if _kernels.on_cpu(xu):
        return build_kkt_schur_plain(model, cost, xu, xs, ee_goal, rho, dt,
                                     integrator_type, angle_wrap)
    dev = xu.device
    N = xu.shape[0]
    nq = model.nq
    nx = 2 * nq
    if nq != 7:
        raise ValueError(f"the CUDA kernels are built for nq = 7, got {nq}")
    _kernels.require_knots(N)
    _kernels.require(xu, "xu", (N, nx + nq), dev)
    _kernels.require(ee_goal[:, :3], "ee_goal[:, :3]", (N, 3), dev,
                     row_major=True)
    packed = model.packed()
    _kernels.require(packed, "model", (packed.numel(),), dev)
    rho_t = _kernels.scalar(rho, dev)

    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(S=torch.empty((N, 3, nx, nx), **f32),
               Pinv=torch.empty((N, 3, nx, nx), **f32),
               gamma=torch.empty((N, nx), **f32),
               Qinv=torch.empty((N, nx, nx), **f32),
               A=torch.empty((N, nx, nx), **f32),
               B=torch.empty((N, nx, nq), **f32),
               q=torch.empty((N, nx), **f32))
    scratch = torch.empty((N * _SCRATCH_PER_KNOT,), **f32)
    code = _kernels.entry("kkt_schur.cu", "kkt_schur_launch")(
        xu.data_ptr(), xu.stride(0), ee_goal.data_ptr(), ee_goal.stride(0),
        rho_t.data_ptr(), float(dt), packed.data_ptr(), float(model.gravity),
        float(cost.qd_cost), float(cost.r_cost), N, integrator_type,
        int(angle_wrap), int(cost.terminal_at_last_state),
        out["S"].data_ptr(), out["Pinv"].data_ptr(), out["gamma"].data_ptr(),
        out["Qinv"].data_ptr(), out["A"].data_ptr(), out["B"].data_ptr(),
        out["q"].data_ptr(), scratch.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.check(code, "kkt_schur_launch")
    build_kkt_schur.launches += 1
    return out


build_kkt_schur.launches = 0
