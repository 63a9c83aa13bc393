"""The port's direct-solver routes against the JAX package on the CPU: the
SQP solve through every direct linsys (``"pcr_cuda"`` runs K7's wrapper,
whose plain version ``pcr_solve_refined`` runs for CPU tensors), the host
closed loop with ``linsys="ldl"``, and the direct-solver tracker script."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SimConfig as JSimConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.sim import mpc as jmpc
from mpcgpu_tpu.solver.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch import track_iiwa_qdldl
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.sim import mpc
from mpcgpu_tpu_torch.solver.sqp import sqp_solve
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

DT = 1.0 / 64.0
RHO = 1e-3

N_SQP = 16
# each direct linsys of the port and the JAX XLA route it is held against
_SQP_ORACLE = {"ldl": "ldl", "pcr": "pcr", "pcr_cuda": "pcr", "qdldl_host": "ldl"}
_JAX_SQP = {}


@pytest.fixture(scope="module")
def sqp_problem():
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[:N_SQP] + 0.01 * rng.standard_normal((N_SQP, 21))
    return xu, xu[0, :14].copy(), load_eepos_traj("0_0")[:N_SQP]


@pytest.mark.parametrize("linsys", list(_SQP_ORACLE))
def test_sqp_direct_matches_jax_f64(sqp_problem, linsys):
    """sqp_solve through each direct linsys, f64, N=16, 3 SQP iterations:
    the same line-search choices as the JAX route, xu within 1e-8, and one
    converged linear solve recorded per iteration."""
    xu, xs, ee = sqp_problem
    oracle = _SQP_ORACLE[linsys]
    if oracle not in _JAX_SQP:
        jm = jax_iiwa14(dtype=jnp.float64)
        _JAX_SQP[oracle] = jax.jit(lambda a, lam, b, g: jax_sqp_solve(
            jm, JCostConfig.for_knots(N_SQP), JSQPConfig(max_iter=3),
            JPCGConfig(), a, lam, b, g, RHO, DT, linsys=oracle))(
            jnp.asarray(xu), jnp.zeros((N_SQP, 14)), jnp.asarray(xs),
            jnp.asarray(ee))
    ref = _JAX_SQP[oracle]
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    got = sqp_solve(iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N_SQP),
                    SQPConfig(max_iter=3), PCGConfig(), t(xu),
                    torch.zeros((N_SQP, 14), dtype=torch.float64), t(xs), t(ee),
                    RHO, DT, linsys=linsys)
    for f in ("ls_alpha_idx", "sqp_iters", "gave_up", "pcg_iters", "pcg_converged"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert got.pcg_iters.tolist() == [1, 1, 1]
    np.testing.assert_allclose(got.xu.numpy(), np.asarray(ref.xu), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(got.rho), float(ref.rho), rtol=1e-10)


def test_simulate_mpc_ldl_matches_jax_f64():
    """The host closed loop through linsys="ldl", f64, N=16, 20 updates:
    the same shift schedule and SQP iteration counts as the JAX loop, and
    tracking errors within 1e-9."""
    xu, ee = load_xu_traj("0_0")[:80], load_eepos_traj("0_0")[:80]
    kw = dict(max_iter=2, max_time_us=None)
    ref = jmpc.simulate_mpc(jax_iiwa14(dtype=jnp.float64), xu, ee, 16, DT,
                            sqp_cfg=JSQPConfig(**kw),
                            sim_cfg=JSimConfig(max_control_updates=20),
                            linsys="ldl", dtype=jnp.float64)
    got = mpc.simulate_mpc(iiwa14(torch.float64, device="cpu"), xu, ee, 16, DT,
                           sqp_cfg=SQPConfig(**kw),
                           sim_cfg=SimConfig(max_control_updates=20), linsys="ldl")
    h, g = np.asarray(ref.tracking_errors), np.asarray(got.tracking_errors)
    assert len(h) == len(g) >= 2
    assert got.sqp_iters == ref.sqp_iters
    np.testing.assert_allclose(g, h, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.final_tracking_error, ref.final_tracking_error,
                               rtol=0, atol=1e-9)


def test_tracker_qdldl_cli_on_cpu(tmp_path, monkeypatch):
    """python -m mpcgpu_tpu_torch.track_iiwa_qdldl on the CPU through the
    host round trip and through K7's wrapper: 3 trajectory steps at N = 2
    (24 control updates), solves cut to 2 SQP iterations; --save writes the
    .result files and the overall CSV."""
    monkeypatch.setattr(track_iiwa_qdldl, "SQPConfig",
                        lambda **kw: SQPConfig(**{"max_iter": 2, **kw}))
    common = ["--device", "cpu", "--knots", "2", "--steps", "3"]
    rows = track_iiwa_qdldl.main(common + ["--linsys", "qdldl_host", "--save",
                                           "--outdir", str(tmp_path)])
    assert len(rows) == 1 and rows[0]["control_updates"] == 24
    assert rows[0]["avg_pcg_iters"] == 1.0 and rows[0]["pcg_maxiter_exit_pct"] == 0.0
    with (tmp_path / "qdldl_2_overall_stats.csv").open() as f:
        assert len(list(csv.DictReader(f))) == 1
    assert (tmp_path / "qdldl_2_0_0_0_tracking_errors.result").is_file()
    rows = track_iiwa_qdldl.main(common + ["--linsys", "pcr_cuda"])
    assert rows[0]["control_updates"] == 24
    assert np.isfinite(rows[0]["avg_tracking_error"])
