"""The port's closed loop (mpcgpu_tpu_torch.sim) against the JAX package's:
the plain plant (K4's plain version), the host control loop with its
statistics, and the tracker script, on the CPU at f64."""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SimConfig as JSimConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.sim import mpc as jmpc
from mpcgpu_tpu_torch import track_iiwa_pcg
from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.sim import mpc
from mpcgpu_tpu_torch.sim.plant_cuda import simulate_plant, simulate_plant_plain
from mpcgpu_tpu_torch.utils.experiment import write_overall_stats_csv
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N = 16
DT = 1.0 / 64.0
# the windows of tests/test_mpc.py::test_plant_pallas_matches_xla_scan (a
# partial window, a full period at an offset, a window near the end of knot
# 0) and one across the knot boundary at 1/64 s
WINDOWS = ((0.0, 5e-4), (2e-3, 2e-3), (1.3e-2, 1.3e-3), (1.5e-2, 2e-3))
# tests/test_mpc.py::test_ondevice_sim_matches_host_loop's settings, f64, and
# a PCG exit at 1e-8 so that the linear solves converge before the cap of 60
SQP = dict(max_iter=2, max_time_us=None)
PCG = dict(max_iter=60, exit_tol=1e-8)
UPDATES = 40


def _plant_inputs():
    plan = load_xu_traj("0_0")[:32]
    xs = plan[0, :14] + 0.01 * np.random.default_rng(0).standard_normal(14)
    return plan, xs


@pytest.mark.parametrize("window", WINDOWS)
def test_plant_matches_jax_f64(window):
    """simulate_plant_plain (K4's plain version) == JAX _simulate_plant at
    f64 (rtol 1e-12: both
    run the same ABA and the same clip schedule; only the summation order
    inside ABA differs, ~1e-16 per operation over 11 substeps)."""
    t_off, sim_t = window
    plan, xs = _plant_inputs()
    ref = jmpc._simulate_plant(jax_iiwa14(dtype=jnp.float64), jnp.asarray(xs),
                               jnp.asarray(plan), t_off, sim_t, DT, 10, 2e-4)
    got = simulate_plant_plain(iiwa14(torch.float64, device="cpu"),
                               torch.tensor(xs), torch.tensor(plan), t_off, sim_t,
                               DT, 10, 2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-15)
    assert not np.allclose(got.numpy(), xs, rtol=0, atol=1e-6)   # it moved


def test_plant_one_window_equals_two():
    """The clip schedule is exact: one 2 ms window == two 1 ms windows, bit
    for bit, through the wrapper (the plain version here)."""
    plan, xs = _plant_inputs()
    m = iiwa14(torch.float64, device="cpu")
    plan, xs = torch.tensor(plan), torch.tensor(xs)
    a1 = simulate_plant(m, xs, plan, 0.0, 1e-3, DT, 10, 2e-4)
    a2 = simulate_plant(m, a1, plan, 1e-3, 1e-3, DT, 10, 2e-4)
    a = simulate_plant(m, xs, plan, 0.0, 2e-3, DT, 10, 2e-4)
    assert torch.equal(a, a2)


@pytest.fixture(scope="module")
def host_runs():
    xu, ee = load_xu_traj("0_0")[:80], load_eepos_traj("0_0")[:80]
    ref = jmpc.simulate_mpc(jax_iiwa14(dtype=jnp.float64), xu, ee, N, DT,
                            sqp_cfg=JSQPConfig(**SQP), pcg_cfg=JPCGConfig(**PCG),
                            sim_cfg=JSimConfig(max_control_updates=UPDATES),
                            linsys="pcg", dtype=jnp.float64)
    got = mpc.simulate_mpc(iiwa14(torch.float64, device="cpu"), xu, ee, N, DT,
                           sqp_cfg=SQPConfig(**SQP), pcg_cfg=PCGConfig(**PCG),
                           sim_cfg=SimConfig(max_control_updates=UPDATES))
    return ref, got


def test_host_loop_matches_jax_f64(host_runs):
    """The host loop with the reference's timing semantics: the same shift
    schedule, the same SQP and PCG iteration counts in every solve, and the
    tracking errors of the first shifts within 1e-12 and of the whole run
    within 1e-9 (measured 3.4e-13: the solves converge before the PCG cap,
    so the f64 rounding of the two packages is not amplified), inside JAX's
    own behavioural tolerance (rtol 0.1, atol 5e-3) many times over."""
    ref, got = host_runs
    h, g = np.asarray(ref.tracking_errors), np.asarray(got.tracking_errors)
    assert len(h) == len(g) >= 3
    assert got.sqp_iters == ref.sqp_iters
    assert got.sqp_exits == ref.sqp_exits
    for a, b in zip(got.linsys_iters, ref.linsys_iters):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.linsys_exits, ref.linsys_exits):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(g[:3], h[:3], rtol=0, atol=1e-12)
    np.testing.assert_allclose(g, h, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.final_tracking_error,
                               ref.final_tracking_error, rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got.tracking_path),
                               np.asarray(ref.tracking_path), rtol=0, atol=1e-9)


def test_stats_summary_and_csv(host_runs, tmp_path):
    """MPCStats.summary() has the JAX keys and values, and the CSV writer
    writes them as the tracker script does."""
    ref, got = host_runs
    s, r = got.summary(), ref.summary()
    assert list(s) == list(r)
    for k in s:
        if k != "avg_sqp_time_us":                 # wall time
            np.testing.assert_allclose(s[k], r[k], rtol=1e-9, atol=1e-9, err_msg=k)
    rows = [dict(s, exit_tol=1e-8, traj="0_0")]
    path = tmp_path / "pcg_16_overall_stats.csv"
    write_overall_stats_csv(path, rows)
    with path.open() as f:
        back = list(csv.DictReader(f))
    assert list(back[0]) == list(rows[0])
    assert float(back[0]["avg_pcg_iters"]) == s["avg_pcg_iters"]


def test_tracker_cli_on_cpu(tmp_path, capsys, monkeypatch):
    """python -m mpcgpu_tpu_torch.track_iiwa_pcg, on the CPU: the host loop
    with --save writes the .result files and the overall CSV; --ondevice
    runs the device loop.  Both track 3 trajectory steps at N = 2: a shift
    every 8 updates of 2 ms (16 ms > 1/64 s), so 24 control updates.  The
    host loop's solves are cut to 2 SQP iterations to keep the test short."""
    monkeypatch.setattr(track_iiwa_pcg, "SQPConfig",
                        lambda **kw: SQPConfig(**{"max_iter": 2, **kw}))
    common = ["--device", "cpu", "--knots", "2", "--steps", "3", "--tols", "1e-5"]
    rows = track_iiwa_pcg.main(common + ["--save", "--outdir", str(tmp_path)])
    assert len(rows) == 1 and rows[0]["control_updates"] == 24
    assert rows[0]["avg_sqp_iters"] <= 2
    assert np.isfinite(rows[0]["avg_pcg_iters"])
    with (tmp_path / "pcg_2_overall_stats.csv").open() as f:
        assert len(list(csv.DictReader(f))) == 1
    assert (tmp_path / "pcg_2_0_0_1e-05_0_tracking_errors.result").is_file()
    track_iiwa_pcg.main(common + ["--ondevice"])
    assert "tol=1e-05: 24 control steps" in capsys.readouterr().out


@pytest.mark.parametrize("period", [2e-3, 3.2724e-3, 1.7e-3])
def test_shift_rule_on_host_and_device(period):
    """mpc._shift_rule, the one shift schedule of all three loops, gives the
    JAX host loop's schedule (its Python float rule, written out here) bit
    for bit over 2000 updates, on numpy scalars as the host loops run it and
    on 0-d f64 tensors as the adaptive device loop runs it."""
    import math

    c, sh = np.float64(0.0), np.bool_(False)
    ct, sht = torch.zeros((), dtype=torch.float64), torch.zeros((), dtype=torch.bool)
    cp, shp = 0.0, False
    shifts = 0
    for _ in range(2000):
        d, c, sh = mpc._shift_rule(c, sh, period, DT, DT)
        dt, ct, sht = mpc._shift_rule(ct, sht, period, DT, DT)
        cp += period
        dp = not shp and cp > DT
        shp = shp or dp
        if cp > DT:
            shp, cp = False, math.fmod(cp, DT)
        assert bool(d) == bool(dt) == dp
        assert float(c) == float(ct) == cp
        shifts += dp
    assert abs(shifts - 2000 * period / DT) <= 1       # one per timestep
