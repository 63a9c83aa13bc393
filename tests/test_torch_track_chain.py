"""The chain tracker (``mpcgpu_tpu_torch/track_chain.py``) on the CPU against
the JAX package's script (``examples/track_chain.py``) at f64.

The reference trace is the JAX script's (the same joint path, its torques
by inverse dynamics, its ee poses), and the tracker's host loop at nq = 3,
N = 16 follows the JAX ``simulate_mpc`` update for update: equal PCG and SQP
iteration counts and exits, tracking errors within 1e-8.  ``--urdf
builtin:iiwa`` loads the IIWA-14 back from its own URDF, and ``main`` runs
both loops end to end at a tiny size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SimConfig as JSimConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import chain as jchain
from mpcgpu_tpu.models import dynamics as jdyn
from mpcgpu_tpu.sim import mpc as jmpc
from mpcgpu_tpu_torch import track_chain
from mpcgpu_tpu_torch.models import iiwa14

torch.set_num_threads(1)

NQ, KNOTS, STEPS, UPDATES = 3, 16, 40, 24


def _models():
    model, origin = track_chain.build_model(NQ, device="cpu", dtype=torch.float64)
    assert origin == f"planar arm of {NQ} links"
    return model, jchain.planar_arm(NQ, link_len=0.4, link_mass=0.8,
                                    dtype=jnp.float64)


def test_reference_trace_matches_the_jax_script():
    """The JAX script's trace: its joint path, jax rnea and fk_ee (f64)."""
    model, jm = _models()
    xu, ee = track_chain.reference_trace(model, STEPS)
    dt = track_chain.DT
    q0 = 0.3 * np.ones(NQ)
    q1 = q0 + np.linspace(0.8, -0.6, NQ)
    t = np.linspace(0.0, 1.0, STEPS)
    blend = 3 * t**2 - 2 * t**3
    q = q0[None, :] + blend[:, None] * (q1 - q0)[None, :]
    qd = np.gradient(q, dt, axis=0)
    qdd = np.gradient(qd, dt, axis=0)
    u = np.asarray(jax.vmap(lambda a, b, c: jdyn.rnea(jm, a, b, c))(
        jnp.asarray(q), jnp.asarray(qd), jnp.asarray(qdd)))
    np.testing.assert_allclose(xu, np.concatenate([q, qd, u], 1), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(
        ee, np.asarray(jax.vmap(lambda a: jdyn.fk_ee(jm, a))(jnp.asarray(q))),
        rtol=0, atol=1e-12)


def test_host_loop_matches_jax_f64():
    model, jm = _models()
    xu, ee = track_chain.reference_trace(model, STEPS)
    got = track_chain.track(model, xu, ee, KNOTS, max_updates=UPDATES)
    c, p, s = track_chain.COST, track_chain.PCG, track_chain.HOST_SQP
    ref = jmpc.simulate_mpc(
        jm, xu, ee, knot_points=KNOTS, timestep=track_chain.DT,
        cost=JCostConfig(qd_cost=c.qd_cost, r_cost=c.r_cost),
        sqp_cfg=JSQPConfig(max_iter=s.max_iter),
        pcg_cfg=JPCGConfig(max_iter=p.max_iter, exit_tol=p.exit_tol),
        sim_cfg=JSimConfig(max_control_updates=UPDATES), linsys="pcg",
        dtype=jnp.float64)
    assert len(got.sqp_iters) == len(ref.sqp_iters) == UPDATES
    assert got.sqp_iters == [int(v) for v in ref.sqp_iters]
    assert got.sqp_exits == [bool(v) for v in ref.sqp_exits]
    for a, b in zip(got.linsys_iters, ref.linsys_iters):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(got.linsys_exits, ref.linsys_exits):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(got.tracking_errors) == len(ref.tracking_errors) >= 2
    np.testing.assert_allclose(got.tracking_errors,
                               np.asarray(ref.tracking_errors, np.float64),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.final_tracking_error,
                               float(ref.final_tracking_error), rtol=0, atol=1e-8)


def test_builtin_iiwa_round_trip():
    model, origin = track_chain.build_model(urdf="builtin:iiwa", device="cpu",
                                            dtype=torch.float64)
    assert "export_urdf -> load_urdf" in origin and model.nq == 7
    want = iiwa14(torch.float64, device="cpu")
    for f in ("xc", "xs", "xcos", "inertia", "hc", "hs", "hcos"):
        torch.testing.assert_close(getattr(model, f), getattr(want, f), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("argv", [
    ["--nq", "2", "--knots", "4", "--steps", "5"],
    ["--nq", "3", "--knots", "4", "--steps", "5", "--ondevice"],
    ["--urdf", "builtin:iiwa", "--knots", "4", "--steps", "4", "--ondevice"],
])
def test_main_runs_on_the_cpu(argv, capsys):
    assert track_chain.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "control steps" in out and "nan" not in out
