"""The port's SQP solve against the JAX reference's XLA path.

The fused path linsys="pcg_cuda" runs the K1/K2/K3 wrappers; on CPU tensors
those are their plain versions, so at f64 the port must follow the JAX
``sqp_solve(linsys="pcg")`` iterate for iterate: identical PCG iteration
counts and line-search choices, xu/lam within 1e-8.
"""

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
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.solver.sqp import make_sqp_solver, sqp_solve

torch.set_num_threads(1)

N = 16
DT = 1.0 / 64.0
RHO = 1e-3


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[:N] + 0.01 * rng.standard_normal((N, 21))
    return xu, xu[0, :14].copy(), load_eepos_traj("0_0")[:N]


_JAX = {}


def _jax_solve(problem, forcing):
    if forcing not in _JAX:
        xu, xs, ee = problem
        jm = jax_iiwa14(dtype=jnp.float64)
        cost = JCostConfig.for_knots(N)
        pcg_cfg = JPCGConfig(max_iter=167, exit_tol=1e-5, forcing=forcing)
        solve = jax.jit(lambda a, lam, b, g: jax_sqp_solve(
            jm, cost, JSQPConfig(max_iter=3), pcg_cfg, a, lam, b, g, RHO, DT,
            linsys="pcg"))
        _JAX[forcing] = solve(jnp.asarray(xu), jnp.zeros((N, 14)),
                              jnp.asarray(xs), jnp.asarray(ee))
    return _JAX[forcing]


def _port_solve(problem, linsys, forcing):
    xu, xs, ee = problem
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    return sqp_solve(iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N),
                     SQPConfig(max_iter=3),
                     PCGConfig(max_iter=167, exit_tol=1e-5, forcing=forcing),
                     t(xu), torch.zeros((N, 14), dtype=torch.float64), t(xs),
                     t(ee), RHO, DT, linsys=linsys)


@pytest.mark.parametrize("linsys,forcing", [("pcg_cuda", "fixed"),
                                            ("pcg", "fixed"),
                                            ("pcg_cuda", "ew")])
def test_sqp_matches_jax_f64(problem, linsys, forcing):
    ref = _jax_solve(problem, forcing)
    got = _port_solve(problem, linsys, forcing)
    for f in ("pcg_iters", "ls_alpha_idx", "pcg_converged", "sqp_iters",
              "gave_up"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("xu", "lam"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0, atol=1e-8,
                                   err_msg=f)
    for f in ("rho", "drho", "merit"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(ref, f)), rtol=1e-10, err_msg=f)


def test_make_sqp_solver_and_iter_budget(problem):
    """The bound solver equals sqp_solve; iter_budget caps the iterations."""
    xu, xs, ee = problem
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    solve = make_sqp_solver(iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N),
                            SQPConfig(max_iter=3),
                            PCGConfig(max_iter=167, exit_tol=1e-5), DT,
                            linsys="pcg_cuda")
    lam0 = torch.zeros((N, 14), dtype=torch.float64)
    full = solve(t(xu), lam0, t(xs), t(ee), RHO)
    ref = _port_solve(problem, "pcg_cuda", "fixed")
    assert torch.equal(full.xu, ref.xu) and torch.equal(full.pcg_iters, ref.pcg_iters)
    one = solve(t(xu), lam0, t(xs), t(ee), RHO, iter_budget=1)
    assert int(one.sqp_iters) == 1
    assert one.pcg_iters.tolist()[1:] == [-1, -1]
    assert one.pcg_iters[0] == full.pcg_iters[0]


def test_unported_and_invalid_paths_raise(problem):
    xu, xs, ee = problem
    args = (iiwa14(torch.float64, device="cpu"), CostConfig(), SQPConfig(max_iter=1),
            PCGConfig(), torch.tensor(xu), torch.zeros((N, 14), dtype=torch.float64),
            torch.tensor(xs), torch.tensor(ee), RHO, DT)
    # the JAX package's kernel routes are spelled with "cuda" in the port
    for linsys, port_name in (("pcr_pallas", "pcr_cuda"), ("pcg_pallas", "pcg_cuda")):
        with pytest.raises(NotImplementedError, match=port_name):
            sqp_solve(*args, linsys=linsys)
    with pytest.raises(ValueError, match="unknown linsys"):
        sqp_solve(*args, linsys="cholesky")
    # the direct solvers run unfused
    with pytest.raises(ValueError, match="unfused"):
        sqp_solve(*args, linsys="ldl", fused=True)
    with pytest.raises(ValueError, match="merit_impl"):
        sqp_solve(*args, merit_impl="pallas")
    # the fused route (K1 -> K2) builds the stair preconditioner only; the
    # split route's K2' takes any 3-band preconditioner but not stair2's 5
    args = args[:3] + (PCGConfig(preconditioner="jacobi"),) + args[4:]
    with pytest.raises(ValueError, match="stair"):
        sqp_solve(*args, linsys="pcg_cuda", fused=True)
    args = args[:3] + (PCGConfig(preconditioner="stair2"),) + args[4:]
    with pytest.raises(ValueError, match="3-band"):
        sqp_solve(*args, linsys="pcg_cuda")
