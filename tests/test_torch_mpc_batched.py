"""The port's batched closed loop (simulate_mpc_ondevice_batched) and its
plant over instances (K4b's plain version) against the JAX package on the
CPU, at f64.

The JAX start perturbation comes from ``jax.random``, which torch cannot
reproduce: the test draws it with the JAX package's key and feeds the same
starts to the port's ``_ondevice_run_batched``.  On the CPU both packages
run the unfused per-instance loop (the JAX package's vmap; the port's loop
over instances), so SQP and PCG counts and the shift mask are held equal
and the tracking errors within 1e-9, as tests/test_torch_mpc_ondevice.py
holds the single loop."""

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
from mpcgpu_tpu_torch import simulate_mpc_ondevice_batched
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel import make_mesh
from mpcgpu_tpu_torch.sim import mpc
from mpcgpu_tpu_torch.sim.plant_cuda import simulate_plant_batched
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N = 16
B = 3
DT = 1.0 / 64.0
SQP = dict(max_iter=2, max_time_us=None)
PCG = dict(max_iter=60, exit_tol=1e-8)
UPDATES = 16
PERTURB, SEED = 0.05, 0


def _traj():
    return load_xu_traj("0_0")[:60], load_eepos_traj("0_0")[:60]


def _port_run(xs0_b, updates=UPDATES):
    """The port's _ondevice_run_batched from the starts xs0_b (B, nx)."""
    xu, ee = _traj()
    model = iiwa14(torch.float64, device="cpu")
    sim = SimConfig(max_control_updates=updates)
    period = sim.simulation_period_us * 1e-6
    xu_t, ee_t = torch.tensor(xu), torch.tensor(ee)
    flags, tails, goal_tails = mpc._ondevice_schedule(
        xu_t, ee_t, N, 7, DT, period, sim.shift_threshold_frac * DT, updates)
    return mpc._ondevice_run_batched(
        model, CostConfig.for_knots(N), SQPConfig(**SQP), PCGConfig(**PCG), "pcg",
        DT, period, int(period / sim.sim_step_time), sim.sim_step_time,
        xu_t[:N], ee_t[:N], torch.tensor(np.array(xs0_b)), flags, tails, goal_tails)


@pytest.fixture(scope="module")
def runs():
    """The JAX _ondevice_run_batched (jitted) and the port's, from the JAX
    function's draw of the starts (sim/mpc.py:812-814), passed on as numpy."""
    xu, ee = _traj()
    sim = JSimConfig(max_control_updates=UPDATES)
    period = sim.simulation_period_us * 1e-6
    f64 = jnp.float64
    flags, tails, goal_tails, offsets, steps, xu_j, ee_j = jmpc._ondevice_schedule(
        xu, ee, N, 14, 7, DT, period, sim.shift_threshold_frac * DT, UPDATES, f64)
    dx0 = PERTURB * jax.random.normal(jax.random.PRNGKey(SEED), (B, 14), f64)
    xs0_b = xu_j[0, :14][None] + dx0
    xu0_b = jnp.broadcast_to(xu_j[:N], (B, N, 21)).at[:, 0, :14].set(xs0_b)
    ref, ref_final = jmpc._ondevice_run_batched(
        jax_iiwa14(dtype=f64), jmpc.CostConfig.for_knots(N), JSQPConfig(**SQP),
        JPCGConfig(**PCG), "pcg", DT, period, int(period / sim.sim_step_time),
        sim.sim_step_time, xu0_b, jnp.zeros((B, N, 14), f64), xs0_b,
        jnp.broadcast_to(ee_j[:N], (B, N, 6)), jnp.full((B,), 1e-3, f64), flags,
        tails, goal_tails, offsets)
    assert steps == UPDATES
    outs, final = _port_run(np.asarray(xs0_b))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    return ref, np.asarray(ref_final), outs, final


def test_batched_loop_matches_jax_f64(runs):
    """Tracking errors at every update (the JAX layout, (B, steps)) within
    1e-9, the final errors too, and the shared shift mask equal."""
    ref, ref_final, outs, final = runs
    np.testing.assert_array_equal(outs["shifted"].numpy(), ref["shifted"])
    assert 2 <= int(ref["shifted"].sum()) < UPDATES
    assert outs["err"].shape == (B, UPDATES) == ref["err"].shape
    np.testing.assert_allclose(outs["err"].numpy(), ref["err"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(final.numpy(), ref_final, rtol=0, atol=1e-9)
    np.testing.assert_allclose(outs["xs"].numpy(), ref["xs"], rtol=0, atol=1e-9)
    # the perturbed instances track differently
    assert len({round(float(v), 9) for v in outs["err"][:, -1]}) == B


def test_batched_loop_counts_match_jax(runs):
    """Identical SQP and PCG iteration counts per instance and update."""
    ref, _, outs, _ = runs
    np.testing.assert_array_equal(outs["sqp_iters"].numpy(), ref["sqp_iters"])
    np.testing.assert_array_equal(outs["pcg_iters"].numpy(), ref["pcg_iters"])


def test_plant_batched_plain_matches_jax():
    """K4b's plain version against the JAX vmap of _simulate_plant, to
    1e-12, over a window that crosses a knot boundary."""
    rng = np.random.default_rng(3)
    xu = load_xu_traj("0_0")[:N]
    xs_b = xu[0, :14] + 0.05 * rng.standard_normal((B, 14))
    plans = xu[None] + 0.01 * rng.standard_normal((B, N, 21))
    jm = jax_iiwa14(dtype=jnp.float64)
    ref = jax.jit(jax.vmap(lambda x, p: jmpc._simulate_plant(
        jm, x, p, jnp.asarray(1.5e-2), jnp.asarray(2e-3), jnp.asarray(DT), 10,
        2e-4)))(jnp.asarray(xs_b), jnp.asarray(plans))
    got = simulate_plant_batched(iiwa14(torch.float64, device="cpu"),
                                 torch.tensor(xs_b), torch.tensor(plans), 1.5e-2,
                                 2e-3, DT, 10, 2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_one_unperturbed_instance_is_the_single_loop():
    """B = 1 with perturb_scale 0 is simulate_mpc_ondevice from the same
    start (tests/test_mpc.py:88-117's check of the JAX package)."""
    xu, ee = _traj()
    model = iiwa14(torch.float64, device="cpu")
    kw = dict(sqp_cfg=SQPConfig(**SQP), pcg_cfg=PCGConfig(**PCG),
              sim_cfg=SimConfig(max_control_updates=12))
    got = simulate_mpc_ondevice_batched(model, xu, ee, N, DT, 1, perturb_scale=0.0,
                                        **kw)
    one = mpc.simulate_mpc_ondevice(model, xu, ee, N, DT, **kw)
    assert got["control_updates"] == one["control_updates"] == 12
    assert got["tracking_errors"].shape == (1, 12)
    mask = got["shift_mask"]
    assert torch.equal(got["tracking_errors"][0][mask], one["tracking_errors"])
    assert torch.equal(got["final_tracking_error"][0], one["final_tracking_error"])


def test_instance_mesh_and_adaptive_mode_raise():
    """A batch that the instance axis does not divide raises (the JAX
    message; tests/test_torch_instance_axis.py runs the instance axis), and
    so does the adaptive mode."""
    xu, ee = _traj()
    model = iiwa14(torch.float64, device="cpu")
    with pytest.raises(ValueError, match="batch 2 not divisible by 4 instance devices"):
        simulate_mpc_ondevice_batched(model, xu, ee, N, DT, 2,
                                      instance_mesh=make_mesh(n_instance=4))
    with pytest.raises(ValueError, match="const_update_freq"):
        simulate_mpc_ondevice_batched(model, xu, ee, N, DT, 2,
                                      sim_cfg=SimConfig(const_update_freq=False))
