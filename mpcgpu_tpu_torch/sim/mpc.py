"""The warm-started MPC chain (first part of the port of mpcgpu_tpu/sim/mpc.py).

``run_chain`` does what the timed body of ``bench.py`` does each control
step: one SQP solve, then the warm-start shift of the plan, the multipliers
and the goal window by one knot, with the next measured state taken from
the plan (xs = xu[1, :nx]).  The closed-loop simulator with its plant comes
in a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.solver.sqp import sqp_solve


def _shift_all(xu, lam, ee_goal, backfill_xu, backfill_goal):
    """Warm-start shift: plan, goal and multipliers move left one knot; the
    tails are backfilled (xu and goal from the given rows, lam duplicated)."""
    xu = torch.cat([xu[1:], backfill_xu[None]])
    ee_goal = torch.cat([ee_goal[1:], backfill_goal[None]])
    lam = torch.cat([lam[1:], lam[-1:]])
    return xu, lam, ee_goal


class ChainResult(NamedTuple):
    xu: torch.Tensor           # (N, nx+nu) plan after the last shift
    lam: torch.Tensor          # (N, nx)
    xs: torch.Tensor           # (nx,)
    ee_goal: torch.Tensor      # (N, 6) goal window after the last shift
    rho: torch.Tensor          # ()
    step_xu: torch.Tensor      # (steps, N, nx+nu) each step's solved plan
    merit: torch.Tensor        # (steps,) each step's final merit
    pcg_iters: torch.Tensor    # (steps,) PCG iterations of each step's first SQP iteration
    ls_alpha_idx: torch.Tensor  # (steps,) line-search choice of each step's first iteration


def run_chain(model: RobotModel, cost: CostConfig, sqp_cfg: SQPConfig,
              pcg_cfg: PCGConfig, xu, lam, xs, ee_full, rho, dt: float,
              steps: int, linsys: str = "pcg_cuda",
              integrator_type: int = 0) -> ChainResult:
    """``steps`` warm-started control steps.  ee_full (L, 6) is the whole
    recorded goal trace: the window is its first N rows, and step i appends
    row (i + N) mod L after the shift.  Nothing is read back to the host."""
    N = xu.shape[0]
    nx = lam.shape[-1]
    ee = ee_full[:N]
    step_xu, merits, iters, alpha_idx = [], [], [], []
    for i in range(steps):
        res = sqp_solve(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee, rho, dt,
                        linsys=linsys, integrator_type=integrator_type)
        step_xu.append(res.xu)
        merits.append(res.merit)
        iters.append(res.pcg_iters[0])
        alpha_idx.append(res.ls_alpha_idx[0])
        xs = res.xu[1, :nx]
        xu, lam, ee = _shift_all(res.xu, res.lam, ee, res.xu[-1],
                                 ee_full[(i + N) % ee_full.shape[0]])
        rho = res.rho
    return ChainResult(xu=xu, lam=lam, xs=xs, ee_goal=ee, rho=rho,
                       step_xu=torch.stack(step_xu), merit=torch.stack(merits),
                       pcg_iters=torch.stack(iters),
                       ls_alpha_idx=torch.stack(alpha_idx))
