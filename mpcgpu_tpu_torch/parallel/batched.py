"""Batched parallel-scenario MPC: B independent SQP solves at once.

Port of ``mpcgpu_tpu/parallel/batched.py::make_batched_sqp_solver``.  The
JAX package vmaps ``sqp_solve`` over a leading instance axis; the port
either runs the instance-grid kernels of ``parallel/batched_cuda.py`` (K8)
or, unfused, a loop of single solves, which computes what the vmap of the
unfused solve computes (every instance runs its own PCG exit, line search
and L-M schedule, and stops on its own).
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.parallel.batched_cuda import (make_batched_fused_solver,
                                                    over_instance_groups)
from mpcgpu_tpu_torch.solver.sqp import SQPResult, sqp_solve


def make_batched_sqp_solver(
    model: RobotModel,
    cost: CostConfig,
    sqp_cfg: SQPConfig,
    pcg_cfg: PCGConfig,
    dt: float,
    linsys: str = "pcg",
    fused: bool | str = "auto",
    mesh=None,
):
    """fn(xu (B,N,nx+nu), lam (B,N,nx), xs (B,nx), ee_goal (B,N,6), rho (B,))
    -> batched SQPResult (each field with a leading instance axis).

    mesh (from ``make_mesh(n_instance, n_knot)`` or
    ``make_host_aligned_mesh``): the instance groups held here are solved
    one after another, each as a batch of its own, and joined; the knot
    axis is not used (each instance's horizon is solved whole, as the JAX
    ``sqp_solve_batched_fused_sharded`` does).  The result is that of the
    instances held here: all of them on one device.

    fused=True: the K8 path (``sqp_solve_batched_fused``).  fused=False: a
    loop of ``sqp_solve(..., linsys=linsys, fused=False)`` over the
    instances, stacked.  fused="auto": the K8 path when xu is on the card,
    the cost is in ee mode, the preconditioner is stair and linsys is "pcg"
    or "pcg_cuda"; the loop otherwise.
    """
    if fused not in ("auto", True, False):
        raise ValueError(f"fused must be 'auto', True or False, got {fused!r}")
    fused_solve = make_batched_fused_solver(model, cost, sqp_cfg, pcg_cfg, dt)

    def looped(xu_b, lam_b, xs_b, ee_b, rho_b):
        results = [sqp_solve(model, cost, sqp_cfg, pcg_cfg, xu_b[i], lam_b[i],
                             xs_b[i], ee_b[i], rho_b[i], dt, linsys=linsys,
                             fused=False) for i in range(xu_b.shape[0])]
        return SQPResult(*(torch.stack(field) for field in zip(*results)))

    def solve(xu_b, lam_b, xs_b, ee_b, rho_b):
        use_fused = fused is True or (
            fused == "auto" and xu_b.device.type == "cuda" and cost.mode == "ee"
            and pcg_cfg.preconditioner == "stair"
            and linsys in ("pcg", "pcg_cuda"))
        run = fused_solve if use_fused else looped
        if mesh is None:
            return run(xu_b, lam_b, xs_b, ee_b, rho_b)
        return over_instance_groups(mesh, run, xu_b, lam_b, xs_b, ee_b, rho_b)

    return solve
