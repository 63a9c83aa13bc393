"""The port's f32 PCR (K7's plain version; K7's wrapper runs it for CPU
tensors) against the JAX package's on the real Schur system in f32, the
system built by the JAX package as tests/test_pcr.py builds it (trace 0_0
plus its jax.random noise).

How well-conditioned that system is depends on the trace files the JAX
loader resolves: a reference checkout's recorded traces when one is
present, else the bundled data/trajfiles, whose trace 0_0 runs away to
joint speeds of up to 264 rad/s in rows 16-26 and gives cond(S) ~1e13 at
N=64 (tools/torch_port_trace_windows.py).  There no f32 PCR keeps a digit
and test_pcr.py's own f32 criterion fails for the JAX function as well.  So
on test_pcr.py's system the port is held to the JAX function's verdict and
accuracy on the same input, and on the calm rows 350-413 of trace 0_0 to
the criterion itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_pcr import _schur

from mpcgpu_tpu.config import CostConfig
from mpcgpu_tpu.models import iiwa14
from mpcgpu_tpu.ops.pcg import pcg_solve as jpcg_solve
from mpcgpu_tpu.ops.pcr import pcr_solve_refined as jpcr_solve_refined
from mpcgpu_tpu.ops.schur import form_schur_system
from mpcgpu_tpu.solver.kkt import build_kkt
from mpcgpu_tpu.utils.trajfiles import load_eepos_traj, load_xu_traj
from mpcgpu_tpu_torch.ops.btd import btd_matvec
from mpcgpu_tpu_torch.ops.ldl import btd_ldl_solve
from mpcgpu_tpu_torch.ops.pcr import pcr_solve_refined
from mpcgpu_tpu_torch.ops.pcr_cuda import pcr_solve_cuda

torch.set_num_threads(1)

CALM_ROW = 350


def _readings(schur) -> dict:
    """(true residual max|S x - b|, max|x - x64| / max|x64|) of the port's
    and the JAX package's f32 PCR (one refinement pass) and of the JAX
    package's capped stair PCG (167 iterations, exit 1e-5, as in
    test_pcr.py); x64 solves the same f32 system in f64."""
    S = torch.tensor(np.asarray(schur.S))
    g = torch.tensor(np.asarray(schur.gamma))
    x64 = btd_ldl_solve(S.double(), g.double())
    port = pcr_solve_refined(S, g)
    assert torch.equal(pcr_solve_cuda(S, g), port)
    sols = {
        "port": port,
        "jax": jpcr_solve_refined(schur.S, schur.gamma, refine=1),
        "pcg": jpcg_solve(schur.S, schur.Pinv, schur.gamma,
                          jnp.zeros_like(schur.gamma), max_iter=167,
                          exit_tol=1e-5).lam,
    }
    out = {}
    for k, x in sols.items():
        x = torch.tensor(np.asarray(x), dtype=torch.float64)
        res = float((btd_matvec(S.double(), x) - g.double()).abs().max())
        out[k] = (res, float((x - x64).abs().max() / x64.abs().max()))
    return out


def test_pcr_f32_matches_jax_on_test_pcr_system():
    """On the input of test_pcr.py::test_pcr_refined_beats_capped_pcg_f32
    (N=64, f32) the port's PCR beats the capped PCG's true residual exactly
    when the JAX function does, and lies no farther from the f64 solve than
    4x the JAX solve does."""
    r = _readings(_schur(64, jnp.float32))
    assert (r["port"][0] < r["pcg"][0]) == (r["jax"][0] < r["pcg"][0]), r
    assert r["port"][1] <= 4 * r["jax"][1], r


def test_pcr_f32_beats_capped_pcg_on_calm_rows():
    """test_pcr.py's criterion on the calm rows of trace 0_0 (N=64 from row
    350, cond(S) 3.5e4): the port's true residual is below the capped PCG's,
    its solve within 1e-3 max|x| of the f64 solve and no farther than 4x the
    JAX solve."""
    N = 64
    rows = slice(CALM_ROW, CALM_ROW + N)
    xu = jnp.asarray(load_xu_traj("0_0")[rows], jnp.float32)
    ee = jnp.asarray(load_eepos_traj("0_0")[rows], jnp.float32)
    xu = xu + 0.01 * jax.random.normal(jax.random.PRNGKey(0), xu.shape, jnp.float32)
    kkt = build_kkt(iiwa14(dtype=jnp.float32), CostConfig.for_knots(N), xu,
                    xu[0, :14], ee, 1 / 64.0)
    r = _readings(form_schur_system(kkt, 1e-3))
    assert r["port"][0] < r["pcg"][0], r
    assert r["port"][1] <= 1e-3, r
    assert r["port"][1] <= 4 * r["jax"][1], r
