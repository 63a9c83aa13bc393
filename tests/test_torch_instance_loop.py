"""The batched closed loop over the instance axis
(``simulate_mpc_ondevice_batched(instance_mesh=make_mesh(n_instance=4))``)
on the CPU, at f64, as tests/test_mpc.py:283 runs the JAX one: B = 8, N =
16, 20 updates of trace 0_0.

Each instance group runs the batched loop on its slab of the starts, which
are drawn for the whole batch first, so the sharded loop equals the
unsharded one bit for bit.  Both are held to the JAX batched loop
(``_ondevice_run_batched``, jitted) from the same starts, which the test
draws as the port does (a torch.Generator seeded with 0; the JAX package's
``jax.random`` draw cannot be reproduced in torch), within 1e-9 as
tests/test_torch_mpc_batched.py holds the unsharded loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SimConfig as JSimConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.sim import mpc as jmpc
from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel import make_mesh
from mpcgpu_tpu_torch.sim.mpc import simulate_mpc_ondevice_batched
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N, B, UPDATES, DT = 16, 8, 20, 1.0 / 64.0
SQP = dict(max_iter=1, max_time_us=None)
PCG = dict(max_iter=40, exit_tol=1e-8)


@pytest.fixture(scope="module")
def loops():
    xu, ee = load_xu_traj("0_0")[:60], load_eepos_traj("0_0")[:60]
    kw = dict(sqp_cfg=SQPConfig(**SQP), pcg_cfg=PCGConfig(**PCG),
              sim_cfg=SimConfig(max_control_updates=UPDATES))
    model = iiwa14(torch.float64, device="cpu")
    ref = simulate_mpc_ondevice_batched(model, xu, ee, N, DT, B, **kw)
    got = simulate_mpc_ondevice_batched(model, xu, ee, N, DT, B,
                                        instance_mesh=make_mesh(n_instance=4), **kw)
    return xu, ee, ref, got


def test_instance_sharded_loop_equals_unsharded_f64(loops):
    _, _, ref, got = loops
    assert got["control_updates"] == ref["control_updates"] == UPDATES
    assert got["tracking_errors"].shape == (B, UPDATES)
    for k in ("tracking_errors", "shift_mask", "final_tracking_error"):
        assert torch.equal(got[k], ref[k]), k
    assert len({round(float(v), 9) for v in got["tracking_errors"][:, -1]}) == B


def test_instance_sharded_loop_matches_jax_f64(loops):
    """The JAX batched loop from the port's starts: tracking errors at every
    update and the final errors within 1e-9, the shift mask equal."""
    xu, ee, _, got = loops
    gen = torch.Generator()
    gen.manual_seed(0)
    dx0 = 0.05 * torch.randn((B, 14), generator=gen, dtype=torch.float64)
    xs0 = jnp.asarray((torch.tensor(xu[0, :14]) + dx0).numpy())
    sim = JSimConfig(max_control_updates=UPDATES)
    period = sim.simulation_period_us * 1e-6
    f64 = jnp.float64
    flags, tails, goal_tails, offsets, steps, xu_j, ee_j = jmpc._ondevice_schedule(
        xu, ee, N, 14, 7, DT, period, sim.shift_threshold_frac * DT, UPDATES, f64)
    xu0_b = jnp.broadcast_to(xu_j[:N], (B, N, 21)).at[:, 0, :14].set(xs0)
    outs, final = jmpc._ondevice_run_batched(
        jax_iiwa14(dtype=f64), jmpc.CostConfig.for_knots(N), JSQPConfig(**SQP),
        JPCGConfig(**PCG), "pcg", DT, period, int(period / sim.sim_step_time),
        sim.sim_step_time, xu0_b, jnp.zeros((B, N, 14), f64), xs0,
        jnp.broadcast_to(ee_j[:N], (B, N, 6)), jnp.full((B,), 1e-3, f64), flags,
        tails, goal_tails, offsets)
    assert steps == UPDATES
    np.testing.assert_array_equal(got["shift_mask"].numpy(), np.asarray(outs["shifted"]))
    np.testing.assert_allclose(got["tracking_errors"].numpy(), np.asarray(outs["err"]),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["final_tracking_error"].numpy(), np.asarray(final),
                               rtol=0, atol=1e-9)
