"""The port's knot-sharded closed loop on the CPU, at f64.

``simulate_mpc_ondevice(knot_mesh=KnotMesh(4))`` runs every solve through
``sqp_solve_sharded`` (N = 16, L = 4).  It must equal the port's unsharded
loop (``linsys="pcg"``, itself held to the JAX package in
tests/test_torch_mpc_ondevice.py) in SQP and PCG iteration counts and shift
schedule, with tracking errors and states within 1e-9: at constant
frequency through the fused route's plain slab versions (K9a -> K10a -> K9b
-> K9c), at adaptive frequency through the unfused pipelined route."""

import numpy as np
import pytest
import torch

from mpcgpu_tpu_torch import track_iiwa_pcg
from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel import KnotMesh
from mpcgpu_tpu_torch.sim import mpc
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N = 16
DT = 1.0 / 64.0
# as tests/test_torch_mpc_ondevice.py: 2 SQP iterations, PCG exit at 1e-8
SQP = dict(max_iter=2, max_time_us=None)
PCG = dict(max_iter=60, exit_tol=1e-8)
UPDATES = 16
PER_ITER_US = 1200.0


def _run(const: bool, **kw):
    sim = SimConfig(max_control_updates=UPDATES, const_update_freq=const)
    return mpc.simulate_mpc_ondevice(
        iiwa14(torch.float64, device="cpu"), load_xu_traj("0_0")[:80],
        load_eepos_traj("0_0")[:80], N, DT, sqp_cfg=SQPConfig(**SQP),
        pcg_cfg=PCGConfig(**PCG), sim_cfg=sim, **kw)


@pytest.mark.parametrize("const,route", [
    (True, dict(fused=True, pcg_method="pipelined_slab")),
    (False, dict(fused=False, pcg_method="pipelined"))])
def test_sharded_loop_equals_unsharded(const, route):
    kw = {} if const else dict(per_iter_us=PER_ITER_US)
    ref = _run(const, linsys="pcg", **kw)
    got = _run(const, knot_mesh=KnotMesh(4), **route, **kw)
    assert got["control_updates"] == ref["control_updates"]
    assert torch.equal(got["sqp_iters"], ref["sqp_iters"])
    assert torch.equal(got["pcg_iters"], ref["pcg_iters"])
    h, g = ref["tracking_errors"].numpy(), got["tracking_errors"].numpy()
    assert len(g) == len(h) >= 2
    np.testing.assert_allclose(g, h, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["xs_path"].numpy(), ref["xs_path"].numpy(),
                               rtol=0, atol=1e-9)
    if not const:
        assert torch.equal(got["sim_times_us"], ref["sim_times_us"])


def test_adaptive_sharded_loop_needs_a_solve_time():
    with pytest.raises(ValueError, match="per_iter_us"):
        _run(False, knot_mesh=KnotMesh(4))


def test_tracker_cli_knot_shards(capsys, monkeypatch):
    """python -m mpcgpu_tpu_torch.track_iiwa_pcg --ondevice --knot-shards 2
    on the CPU: N = 2 over 2 shards, 3 trajectory steps (24 updates), the
    PCG cut to 10 iterations to keep the test short."""
    monkeypatch.setattr(track_iiwa_pcg.PCGConfig, "tuned_max_iter",
                        staticmethod(lambda knots: 10))
    args = ["--device", "cpu", "--knots", "2", "--steps", "3", "--tols", "1e-5",
            "--ondevice", "--knot-shards", "2"]
    track_iiwa_pcg.main(args)
    assert "tol=1e-05: 24 control steps" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        track_iiwa_pcg.main(args[:-3] + args[-2:])
