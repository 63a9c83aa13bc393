"""Driver of a fleet of arms on one card: the port's batched SQP solve
(``parallel/batched_cuda.py``: K8a -> K8b -> K8c -> K3b per iteration) and
the batched plant (K4b), every instance in one launch of each."""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel.batched_cuda import make_batched_fused_solver
from mpcgpu_tpu_torch.sim.plant_cuda import simulate_plant_batched

from portbench.drivers import Step, port_configs


class Driver:
    def __init__(self, cfg: dict, dev: torch.device):
        self.model = iiwa14(torch.float32, device=dev, gravity=cfg["gravity"])
        cost, sqp, pcg = port_configs(cfg)
        self.solver = make_batched_fused_solver(self.model, cost, sqp, pcg,
                                                cfg["dt"])

    def solve(self, xu, lam, xs, ee, rho) -> Step:
        res = self.solver(xu, lam, xs, ee, rho)
        return Step(res.xu, res.lam, res.rho, res.merit, res.pcg_iters)

    def plant(self, xs, xu_plan, t_off, sim_time, timestep, n_sub: int,
              sim_step: float):
        return simulate_plant_batched(self.model, xs, xu_plan, t_off, sim_time,
                                      timestep, n_sub, sim_step)
