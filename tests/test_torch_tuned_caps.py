"""The port's last gaps to the JAX package, on the CPU: the H100's own PCG
cap table (``PCGConfig.tuned_max_iter_h100``) and the tool that tunes it
(``tools/torch_port_tune_pcg_caps.py``), the batched solve's
``merit_impl`` against ``vmap(sqp_solve)`` of the JAX XLA path, and
``utils/profiling``."""

import functools
import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.solver.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel.batched_cuda import sqp_solve_batched_fused
from mpcgpu_tpu_torch.utils.profiling import WallTimer, time_jitted, trace
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REFERENCE_CAPS = {32: 173, 64: 167, 128: 167, 256: 118, 512: 67}


@functools.cache
def _tool():
    """tools/torch_port_tune_pcg_caps.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "torch_port_tune_pcg_caps", ROOT / "tools" / "torch_port_tune_pcg_caps.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the cap table ---------------------------------------------------------

def test_h100_tuned_cap_table():
    """The H100 table (the tuning run's selection, PERF.md) re-tunes no
    horizon: re-tuning lost at N = 32, 64 and 128, so every horizon falls
    back to the reference caps, as tests/test_utils.py::
    test_tpu_tuned_cap_table holds the JAX package's fallbacks."""
    assert [PCGConfig.tuned_max_iter(n) for n in REFERENCE_CAPS] \
        == list(REFERENCE_CAPS.values())
    for n in (16, *REFERENCE_CAPS, 1024):
        assert PCGConfig.tuned_max_iter_h100(n) == PCGConfig.tuned_max_iter(n)
    assert PCGConfig.tuned_max_iter_h100(1024) == 200


# ---- select_cap ------------------------------------------------------------

def _row(cap, err, lat, runs=None, finite=True):
    runs = runs if runs is not None else [lat - 10.0, lat, lat + 10.0]
    return dict(pcg_cap=cap, finite=finite, ensemble_median=err, latency_us=lat,
                latency_runs_us=runs)


def test_select_cap_passes_a_faster_cap_within_five_percent():
    rows = [_row(40, 0.52, 1500.0), _row(80, 0.50, 1700.0), _row(167, 0.50, 2000.0)]
    assert _tool().select_cap(rows, 167) == 40
    # the fastest of those that pass, not the lowest cap
    rows = [_row(40, 0.60, 1400.0), _row(80, 0.525, 1600.0), _row(167, 0.50, 2000.0)]
    assert _tool().select_cap(rows, 167) == 80


@pytest.mark.parametrize("case", ["six_percent_worse", "inside_the_spread",
                                  "non_finite_loop", "no_shift"])
def test_select_cap_refuses(case):
    """A cap 6% worse, one faster by less than the larger run-to-run range,
    one with a non-finite loop, and errors that are null: the reference cap
    stays."""
    ref = _row(167, 0.50, 2000.0)
    rows = {"six_percent_worse": [_row(80, 0.53, 1500.0), ref],
            "inside_the_spread": [_row(80, 0.50, 1950.0, [1900.0, 1950.0, 2000.0]),
                                  _row(167, 0.50, 2000.0, [1980.0, 2000.0, 2060.0])],
            "non_finite_loop": [_row(80, 0.40, 1500.0, finite=False), ref],
            "no_shift": [_row(80, None, 1500.0), ref]}[case]
    assert _tool().select_cap(rows, 167) == 167


def test_tune_tool_prints_a_row_per_cap_on_the_cpu(capsys):
    """The tool on --device cpu (the plain versions) at N=16, caps 4 and 8,
    6 updates, an ensemble of 2: one parseable JSON row per cap with the
    JAX tool's fields and the port's, on the device it names."""
    rc = _tool().main(["--device", "cpu", "--knots", "16", "--caps", "4", "8",
                       "--steps", "6", "--ensemble", "2"])
    assert rc == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["pcg_cap"] for r in rows] == [4, 8]
    for r in rows:
        assert r["knots"] == 16 and r["device"] == "cpu" and r["control_updates"] == 6
        for key in ("us_per_control_step", "final_tracking_error", "mean_pcg_iters",
                    "max_iter_exit_pct", "latency_us"):
            assert math.isfinite(r[key]) and r[key] >= 0, key
        assert len(r["latency_runs_us"]) == 3 and len(r["ensemble_errors"]) == 3
        assert r["mean_pcg_iters"] <= r["pcg_cap"] and r["finite"]
        assert r["k2_us_per_update"] is None        # no kernel on the CPU
        assert "avg_tracking_error" in r and "ensemble_median" in r


# ---- the batched solve's merit_impl ----------------------------------------

B, N = 3, 16
DT = 1.0 / 64.0
SQP = dict(max_iter=2)
PCG = dict(max_iter=60, exit_tol=1e-8)


def _inputs():
    """B noisy copies of trace 0_0 (numpy seed 0), per-instance rho."""
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[:N][None] + 0.02 * rng.standard_normal((B, N, 21))
    ee = np.broadcast_to(load_eepos_traj("0_0")[:N], (B, N, 6)).copy()
    return xu, np.zeros((B, N, 14)), xu[:, 0, :14].copy(), ee, np.array([1e-3, 2e-3, 5e-3])


def _port(merit_impl):
    return sqp_solve_batched_fused(
        iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N), SQPConfig(**SQP),
        PCGConfig(**PCG), *map(torch.tensor, _inputs()), DT, merit_impl=merit_impl)


def test_batched_merit_impl_plain_matches_jax_vmap():
    """merit_impl="plain" (line_search_merits per instance), f64: the same
    PCG iterations, line-search choices, SQP iterations and give-ups as the
    vmap of the JAX solve (linsys="pcg"), xu and lam within 1e-8, as
    tests/test_torch_batched.py holds the default route."""
    jm, jc = jax_iiwa14(dtype=jnp.float64), JCostConfig.for_knots(N)
    ref = jax.jit(jax.vmap(lambda xu, lam, xs, ee, rho: jax_sqp_solve(
        jm, jc, JSQPConfig(**SQP), JPCGConfig(**PCG), xu, lam, xs, ee, rho, DT,
        linsys="pcg")))(*map(jnp.asarray, _inputs()))
    got = _port("plain")
    for f in ("pcg_iters", "ls_alpha_idx", "pcg_converged", "sqp_iters", "gave_up"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.xu.numpy(), np.asarray(ref.xu), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam), rtol=0,
                               atol=1e-8 * float(np.abs(ref.lam).max()))
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(ref.rho), rtol=1e-10)


@pytest.mark.parametrize("impl", ["cuda", "auto"])
def test_batched_merit_impl_kernel_route_equals_plain_on_the_cpu(impl):
    """On CPU tensors "cuda" and "auto" run the batched K3's plain version:
    the same SQPResult as "plain", bit for bit."""
    got, ref = _port(impl), _port("plain")
    for f in ref._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_batched_merit_impl_unknown_raises():
    with pytest.raises(ValueError, match="merit_impl"):
        _port("pallas")


# ---- utils/profiling -------------------------------------------------------

def test_profiling_helpers(tmp_path):
    """time_jitted returns a positive median, WallTimer one sample per
    measure, and trace a Chrome trace file in the directory it is given."""
    x = torch.ones(64, 64)
    assert time_jitted(torch.matmul, x, x, reps=5, warmup=1) > 0
    timer = WallTimer()
    for _ in range(3):
        out = {}
        with timer.measure(out):
            out["y"] = x @ x
    assert len(timer.samples_us) == 3 and all(s > 0 for s in timer.samples_us)
    with trace(str(tmp_path)) as prof:
        (x @ x).sum()
    assert Path(prof.trace_path).parent == tmp_path
    assert Path(prof.trace_path).stat().st_size > 0
    assert any("matmul" in ev.key or "mm" in ev.key for ev in prof.key_averages())
