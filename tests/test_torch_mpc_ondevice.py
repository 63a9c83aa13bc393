"""The port's closed loop as device work (simulate_mpc_ondevice, constant
and adaptive frequency) against the JAX package's, on the CPU at f64."""

import jax.numpy as jnp
import numpy as np
import torch

from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SimConfig as JSimConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.sim import mpc as jmpc
from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.sim import mpc

torch.set_num_threads(1)

N = 16
DT = 1.0 / 64.0
# as tests/test_torch_mpc.py: f64, 2 SQP iterations, PCG exit at 1e-8 so
# that the solves converge before the cap and f64 rounding is not amplified
SQP = dict(max_iter=2, max_time_us=None)
PCG = dict(max_iter=60, exit_tol=1e-8)
UPDATES = 40


def _run(const: bool, **kw):
    from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

    xu, ee = load_xu_traj("0_0")[:80], load_eepos_traj("0_0")[:80]
    sim = dict(max_control_updates=UPDATES, const_update_freq=const)
    ref = jmpc.simulate_mpc_ondevice(
        jax_iiwa14(dtype=jnp.float64), xu, ee, N, DT, sqp_cfg=JSQPConfig(**SQP),
        pcg_cfg=JPCGConfig(**PCG), sim_cfg=JSimConfig(**sim), linsys="pcg",
        dtype=jnp.float64, **kw)
    got = mpc.simulate_mpc_ondevice(
        iiwa14(torch.float64, device="cpu"), xu, ee, N, DT,
        sqp_cfg=SQPConfig(**SQP), pcg_cfg=PCGConfig(**PCG),
        sim_cfg=SimConfig(**sim), **kw)
    return {k: np.asarray(v) for k, v in ref.items()}, \
        {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in got.items()}


def _check(ref, got):
    """Identical SQP and PCG iteration counts and shift schedule; tracking
    errors of the first shifts within 1e-12, of the whole run within 1e-9
    (measured <= 3.4e-14), and the measured-state path within 1e-9."""
    assert got["control_updates"] == ref["control_updates"]
    np.testing.assert_array_equal(got["sqp_iters"], ref["sqp_iters"])
    np.testing.assert_array_equal(got["pcg_iters"], ref["pcg_iters"])
    h, g = ref["tracking_errors"], got["tracking_errors"]
    assert len(g) == len(h) >= 3
    np.testing.assert_allclose(g[:3], h[:3], rtol=0, atol=1e-12)
    np.testing.assert_allclose(g, h, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["xs_path"], ref["xs_path"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["final_tracking_error"],
                               ref["final_tracking_error"], rtol=0, atol=1e-9)


def test_ondevice_const_matches_jax_f64():
    ref, got = _run(True)
    assert got["control_updates"] == UPDATES
    _check(ref, got)


def test_ondevice_adaptive_matches_jax_f64():
    """Adaptive frequency with a given solve-time model (per_iter_us): the
    data-dependent shift schedule on the device, and the modelled sim times
    equal per_iter_us * sqp_iters as in tests/test_mpc.py."""
    ref, got = _run(False, per_iter_us=4000.0)
    _check(ref, got)
    np.testing.assert_array_equal(got["sim_times_us"], ref["sim_times_us"])
    np.testing.assert_allclose(got["sim_times_us"], 4000.0 * got["sqp_iters"],
                               rtol=1e-12)
    assert got["per_iter_us"] == 4000.0
