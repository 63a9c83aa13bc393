"""The systems under test.  A configuration names its driver
(``"driver": "arm"`` -> ``drivers/arm.py``); a driver module holds a class
``Driver(cfg, device)`` with

  * ``solve(xu, lam, xs, ee, rho) -> Step``: one control update's solve,
    the timed call, on tensors with a leading instance axis;
  * ``plant(xs, xu_plan, t_off, sim_time, timestep, n_sub, sim_step)``: the
    measured states after one control period under the plans.

A driver calls only the port's public functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Step(NamedTuple):
    """What a solve returns, each with the leading instance axis."""

    xu: torch.Tensor         # (B, N, nx + nu) the new plan
    lam: torch.Tensor        # (B, N, nx) its multipliers
    rho: torch.Tensor        # (B,) the next regularization
    merit: torch.Tensor      # (B,) the plan's merit as its line search saw it
    pcg_iters: torch.Tensor  # (B, sqp_max_iter) PCG iterations, -1 = not run


def port_configs(cfg: dict):
    """The configuration file's settings as the port's config objects."""
    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig

    cost = CostConfig(qd_cost=cfg["qd_cost"], r_cost=cfg["r_cost"],
                      mode=cfg["cost_mode"])
    sqp = SQPConfig(max_iter=cfg["sqp_max_iter"],
                    max_time_us=cfg["sqp_max_time_us"],
                    num_alphas=cfg["num_alphas"], mu=cfg["mu"],
                    rho_min=cfg["rho_min"], rho_factor=cfg["rho_factor"],
                    rho_max=cfg["rho_max"], rho_reset=cfg["rho_reset"])
    pcg = PCGConfig(max_iter=cfg["pcg_max_iter"], exit_tol=cfg["pcg_exit_tol"],
                    preconditioner=cfg["pcg_preconditioner"],
                    exit_criterion=cfg["pcg_exit_criterion"])
    return cost, sqp, pcg
