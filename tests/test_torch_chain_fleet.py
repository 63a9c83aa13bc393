"""The batched closed loop of planar arms of 3 and 5 links (the chain
tracker's) over the instance axis, against the JAX package on the CPU, at
f64.

``simulate_mpc_ondevice_batched(instance_mesh=make_mesh(n_instance=2))``
matches the JAX batched loop (``_ondevice_run_batched``, jitted) from the
same starts within 1e-9, as tests/test_torch_instance_loop.py holds the
IIWA's (which also holds the sharded loop to the unsharded one bit for
bit).  The starts are drawn as
the port draws them (a torch.Generator seeded with 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SimConfig as JSimConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import chain as jchain
from mpcgpu_tpu.sim import mpc as jmpc
from mpcgpu_tpu_torch import track_chain
from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.parallel import make_mesh
from mpcgpu_tpu_torch.sim.mpc import simulate_mpc_ondevice_batched

torch.set_num_threads(1)

N, B, UPDATES, ROWS, DT = 16, 4, 17, 48, track_chain.DT
SQP = dict(max_iter=1, max_time_us=None)
PCG = dict(max_iter=60, exit_tol=1e-8)


@pytest.mark.parametrize("nq", [3, 5])
def test_chain_fleet_over_instances_matches_jax_f64(nq):
    nx = 2 * nq
    model = track_chain.build_model(nq, device="cpu", dtype=torch.float64)[0]
    xu, ee = track_chain.reference_trace(model, ROWS)
    kw = dict(cost=track_chain.COST, sqp_cfg=SQPConfig(**SQP),
              pcg_cfg=PCGConfig(**PCG), sim_cfg=SimConfig(max_control_updates=UPDATES))
    got = simulate_mpc_ondevice_batched(model, xu, ee, N, DT, B,
                                        instance_mesh=make_mesh(n_instance=2), **kw)
    assert got["tracking_errors"].shape == (B, UPDATES)
    assert 2 <= int(got["shift_mask"].sum()) < UPDATES

    gen = torch.Generator()
    gen.manual_seed(0)
    dx0 = 0.05 * torch.randn((B, nx), generator=gen, dtype=torch.float64)
    xs0 = jnp.asarray((torch.tensor(xu[0, :nx]) + dx0).numpy())
    sim = JSimConfig(max_control_updates=UPDATES)
    period = sim.simulation_period_us * 1e-6
    f64 = jnp.float64
    flags, tails, goal_tails, offsets, steps, xu_j, ee_j = jmpc._ondevice_schedule(
        xu, ee, N, nx, nq, DT, period, sim.shift_threshold_frac * DT, UPDATES, f64)
    xu0_b = jnp.broadcast_to(xu_j[:N], (B, N, 3 * nq)).at[:, 0, :nx].set(xs0)
    outs, final = jmpc._ondevice_run_batched(
        jchain.planar_arm(nq, link_len=0.4, link_mass=0.8, dtype=f64),
        JCostConfig(qd_cost=track_chain.COST.qd_cost, r_cost=track_chain.COST.r_cost),
        JSQPConfig(**SQP), JPCGConfig(**PCG), "pcg", DT, period,
        int(period / sim.sim_step_time), sim.sim_step_time, xu0_b,
        jnp.zeros((B, N, nx), f64), xs0, jnp.broadcast_to(ee_j[:N], (B, N, 6)),
        jnp.full((B,), 1e-3, f64), flags, tails, goal_tails, offsets)
    assert steps == UPDATES
    np.testing.assert_array_equal(got["shift_mask"].numpy(), np.asarray(outs["shifted"]))
    np.testing.assert_allclose(got["tracking_errors"].numpy(), np.asarray(outs["err"]),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["final_tracking_error"].numpy(), np.asarray(final),
                               rtol=0, atol=1e-9)
