"""The port's pcg_solve(precond_poly=2) against the JAX package's at f64.

precond_poly=2 applies the first-order polynomial refinement
z = (2 Pinv - Pinv S Pinv) r in the loop (mpcgpu_tpu/ops/pcg.py:52-66);
both packages run it on their own form_schur_system of one seeded problem
(N=16, trace 0_0 + numpy noise, seed 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.ops import pcg as jpcg
from mpcgpu_tpu.ops import schur as jschur
from mpcgpu_tpu.solver import kkt as jkkt
from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.ops import pcg, schur
from mpcgpu_tpu_torch.ops.btd import btd_to_dense
from mpcgpu_tpu_torch.solver import kkt
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N = 16
DT = 1.0 / 64.0
RHO = 1e-3


@pytest.fixture(scope="module")
def systems():
    """(JAX SchurSystem, port SchurSystem) of the same problem at f64."""
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[:N] + 0.01 * rng.standard_normal((N, 21))
    ee = load_eepos_traj("0_0")[:N]
    xs = xu[0, :14]
    jm = jax_iiwa14(dtype=jnp.float64)
    jk = jax.jit(lambda a, b, g: jkkt.build_kkt(jm, JCostConfig(), a, b, g, DT))(
        jnp.asarray(xu), jnp.asarray(xs), jnp.asarray(ee))
    tk = kkt.build_kkt(iiwa14(torch.float64, device="cpu"), CostConfig(),
                       torch.tensor(xu), torch.tensor(xs), torch.tensor(ee), DT)
    return jschur.form_schur_system(jk, RHO), schur.form_schur_system(tk, RHO)


@pytest.mark.parametrize("criterion,tol,max_iter", [
    ("rnorm", 1e-12, 500),     # solved to the exit
    ("eta", 1e-8, 500),
    ("eta", 1e-8, 5),          # capped
])
def test_precond_poly2_matches_jax(systems, criterion, tol, max_iter):
    """The same iterations and exit flag as the JAX function, lam within
    1e-10 of its scale."""
    sj, st = systems
    lam0 = np.zeros((N, 14))
    rj = jpcg.pcg_solve(sj.S, sj.Pinv, sj.gamma, jnp.asarray(lam0),
                        max_iter=max_iter, exit_tol=tol, exit_criterion=criterion,
                        precond_poly=2)
    rt = pcg.pcg_solve(st.S, st.Pinv, st.gamma, torch.tensor(lam0),
                       max_iter=max_iter, exit_tol=tol, exit_criterion=criterion,
                       precond_poly=2)
    assert int(rt.iters) == int(rj.iters)
    assert bool(rt.converged) == bool(rj.converged)
    ref = np.asarray(rj.lam)
    np.testing.assert_allclose(rt.lam.numpy(), ref, rtol=0,
                               atol=1e-10 * float(np.abs(ref).max()))


def test_precond_poly2_converges_to_the_dense_solve(systems):
    """tests/test_kkt_schur.py::test_precond_poly2's criterion on the port:
    the rnorm exit at 1e-12 is reached and lam is the dense solve's within
    1e-6."""
    _, st = systems
    lam_dense = np.linalg.solve(btd_to_dense(st.S).numpy(),
                                st.gamma.numpy().ravel()).reshape(N, 14)
    res = pcg.pcg_solve(st.S, st.Pinv, st.gamma, torch.zeros((N, 14), dtype=torch.float64),
                        max_iter=500, exit_tol=1e-12, exit_criterion="rnorm",
                        precond_poly=2)
    assert bool(res.converged)
    np.testing.assert_allclose(res.lam.numpy(), lam_dense, atol=1e-6)


def test_precond_poly_other_values_raise(systems):
    """Only 1 and 2: 3 raises a ValueError in both packages."""
    sj, st = systems
    with pytest.raises(ValueError, match="precond_poly"):
        jpcg.pcg_solve(sj.S, sj.Pinv, sj.gamma, jnp.zeros((N, 14)), precond_poly=3)
    with pytest.raises(ValueError, match="precond_poly"):
        pcg.pcg_solve(st.S, st.Pinv, st.gamma, torch.zeros((N, 14), dtype=torch.float64),
                      precond_poly=3)
