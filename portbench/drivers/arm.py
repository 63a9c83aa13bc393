"""Driver of one arm: the port's SQP solve (``solver/sqp.py``, the fused
kernels K1 -> K2 -> K3 on the card) and its plant (K4).

The harness keeps every tensor with a leading instance axis of 1; this
driver drops it for the single-instance entry points and adds it back to
their results (views, no launches).
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.sim.plant_cuda import simulate_plant
from mpcgpu_tpu_torch.solver.sqp import make_sqp_solver

from portbench.drivers import Step, port_configs


class Driver:
    def __init__(self, cfg: dict, dev: torch.device):
        if cfg["batch"] != 1:
            raise ValueError("the arm driver runs one instance")
        self.model = iiwa14(torch.float32, device=dev, gravity=cfg["gravity"])
        cost, sqp, pcg = port_configs(cfg)
        self.solver = make_sqp_solver(self.model, cost, sqp, pcg, cfg["dt"],
                                      linsys=cfg["linsys"])

    def solve(self, xu, lam, xs, ee, rho) -> Step:
        res = self.solver(xu[0], lam[0], xs[0], ee[0], rho[0])
        return Step(res.xu[None], res.lam[None], res.rho[None],
                    res.merit[None], res.pcg_iters[None])

    def plant(self, xs, xu_plan, t_off, sim_time, timestep, n_sub: int,
              sim_step: float):
        return simulate_plant(self.model, xs[0], xu_plan[0], t_off, sim_time,
                              timestep, n_sub, sim_step)[None]
