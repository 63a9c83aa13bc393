"""The time-budget modes of the port's closed loop (SQP_MAX_TIME_US, the
reference's sqpTimecheck) on the CPU, as tests/test_mpc.py::
test_time_budget_ondevice runs them for the JAX package: "ondevice" turns
the budget into an iteration cap by one calibration, "host" chunks
1-iteration solves under a wall-clock check."""

import numpy as np
import pytest
import torch

from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.sim.mpc import simulate_mpc
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)


@pytest.mark.parametrize("impl", ["ondevice", "host"])
def test_time_budget_modes(impl):
    """SQP_MAX_TIME_US enforced both ways, as
    tests/test_mpc.py::test_time_budget_ondevice runs it: a huge budget
    leaves the cap at max_iter, and the solver iterates."""
    stats = simulate_mpc(
        iiwa14(torch.float32, device="cpu"), load_xu_traj("0_0")[:40],
        load_eepos_traj("0_0")[:40], knot_points=16, timestep=1 / 64.0,
        sqp_cfg=SQPConfig(max_iter=8, max_time_us=10_000_000.0),
        pcg_cfg=PCGConfig(max_iter=60, exit_tol=1e-6),
        sim_cfg=SimConfig(max_control_updates=10, time_budget_mode=True,
                          time_budget_impl=impl))
    s = stats.summary()
    assert s["control_updates"] == 10
    assert 1 <= max(stats.sqp_iters) <= 8
    assert all(len(v) == n for v, n in zip(stats.linsys_iters, stats.sqp_iters))
    assert np.isfinite(s["avg_tracking_error"])
    assert np.isfinite(s["avg_pcg_iters"])
