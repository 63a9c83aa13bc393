"""Port KKT assembly, Schur condensation, dz recovery and PCG against the
JAX reference's XLA functions at f64 (N=16, trace 0_0 + seeded numpy noise)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.ops import btd as jbtd
from mpcgpu_tpu.ops import pcg as jpcg
from mpcgpu_tpu.ops import schur as jschur
from mpcgpu_tpu.ops import smallmat as jsmall
from mpcgpu_tpu.solver import kkt as jkkt
from mpcgpu_tpu.solver import merit as jmerit
from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.ops import btd, pcg, schur, smallmat
from mpcgpu_tpu_torch.solver import kkt, merit

torch.set_num_threads(1)

N = 16
DT = 1.0 / 64.0
RHO = 1e-3


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[:N] + 0.01 * rng.standard_normal((N, 21))
    ee = load_eepos_traj("0_0")[:N]
    return xu, xu[0, :14], ee


_KKT_CACHE = {}


def _kkt_pair(problem, integrator_type=0, wrap=False, **cost_kw):
    key = (integrator_type, wrap, tuple(sorted(cost_kw.items())))
    if key not in _KKT_CACHE:
        _KKT_CACHE[key] = _build_kkt_pair(problem, integrator_type, wrap, **cost_kw)
    return _KKT_CACHE[key]


def _build_kkt_pair(problem, integrator_type, wrap, **cost_kw):
    xu, xs, ee = problem
    cost = CostConfig(**cost_kw)
    goal = ee if cost.mode == "ee" else xu[:, :14]
    jm, jc = jax_iiwa14(dtype=jnp.float64), JCostConfig(**cost_kw)
    j = jax.jit(lambda a, b, g: jkkt.build_kkt(jm, jc, a, b, g, DT, integrator_type,
                                               wrap))(
        jnp.asarray(xu), jnp.asarray(xs), jnp.asarray(goal))
    t = kkt.build_kkt(iiwa14(torch.float64, device="cpu"), cost, torch.tensor(xu),
                      torch.tensor(xs), torch.tensor(goal), DT,
                      integrator_type, wrap)
    return j, t


@pytest.mark.parametrize("integrator_type,wrap,cost_kw", [
    (0, False, {}),
    (1, True, {"terminal_at_last_state": False}),
    (1, False, {"mode": "joint"}),
    (0, True, {"mode": "joint", "absolute_qd_penalty": True}),
])
def test_build_kkt_matches_jax(problem, integrator_type, wrap, cost_kw):
    j, t = _kkt_pair(problem, integrator_type, wrap, **cost_kw)
    for f in ("Q", "q", "R", "r", "A", "B", "c"):
        _close(getattr(t, f), getattr(j, f), 1e-9)


def test_angle_wrap_and_integrator_step_match_jax():
    rng = np.random.default_rng(2)
    q = 4.0 * rng.standard_normal(64)
    _close(kkt.angle_wrap(torch.tensor(q)), jkkt.angle_wrap(jnp.asarray(q)), 0)
    x, u = rng.standard_normal((N, 14)), rng.standard_normal((N, 7))
    jm, tm = jax_iiwa14(dtype=jnp.float64), iiwa14(torch.float64, device="cpu")
    for it in (0, 1):
        ref = jax.vmap(lambda a, b: jkkt.integrator_step(jm, a, b, DT, it, True))(
            jnp.asarray(x), jnp.asarray(u))
        _close(kkt.integrator_step(tm, torch.tensor(x), torch.tensor(u), DT, it, True),
               ref, 1e-12)


@pytest.mark.parametrize("preconditioner", ["stair", "jacobi", "none", "stair2"])
def test_form_schur_system_and_dz_match_jax(problem, preconditioner):
    j, t = _kkt_pair(problem)
    sj = jschur.form_schur_system(j, RHO, preconditioner)
    st = schur.form_schur_system(t, RHO, preconditioner)
    for f in ("S", "Pinv", "gamma", "Qinv", "Rinv"):
        _close(getattr(st, f), getattr(sj, f), 1e-9)
    lam = np.random.default_rng(3).standard_normal((N, 14))
    _close(schur.compute_dz(t, st, torch.tensor(lam)),
           jschur.compute_dz(j, sj, jnp.asarray(lam)), 1e-9)


@pytest.mark.parametrize("criterion,tol", [("eta", 1e-5), ("rnorm", 1e-3)])
def test_pcg_matches_jax(problem, criterion, tol):
    """Identical iteration counts and exit flags; lam to 1e-9: a cold start
    solved to the exit, and a warm start capped after 7 and 0 steps."""
    j, t = _kkt_pair(problem)
    sj = jschur.form_schur_system(j, RHO)
    st = schur.form_schur_system(t, RHO)
    warm = 0.1 * np.random.default_rng(4).standard_normal((N, 14))
    for max_iter, lam0 in ((200, np.zeros((N, 14))), (7, warm), (0, warm)):
        rj = jpcg.pcg_solve(sj.S, sj.Pinv, sj.gamma, jnp.asarray(lam0),
                            max_iter=max_iter, exit_tol=tol,
                            exit_criterion=criterion)
        rt = pcg.pcg_solve(st.S, st.Pinv, st.gamma, torch.tensor(lam0),
                           max_iter=max_iter, exit_tol=tol,
                           exit_criterion=criterion)
        assert int(rt.iters) == int(rj.iters), (max_iter, int(rt.iters), int(rj.iters))
        assert bool(rt.converged) == bool(rj.converged)
        _close(rt.lam, rj.lam, 1e-9)
    with pytest.raises(ValueError):
        pcg.pcg_solve(st.S, st.Pinv, st.gamma, torch.tensor(lam0), exit_criterion="x")


def test_btd_and_smallmat_match_jax():
    rng = np.random.default_rng(5)
    for bands in (3, 5):
        S = rng.standard_normal((N, bands, 14, 14))
        x = rng.standard_normal((N, 14))
        _close(btd.btd_matvec(torch.tensor(S), torch.tensor(x)),
               jbtd.btd_matvec(jnp.asarray(S), jnp.asarray(x)), 1e-12)
    S = rng.standard_normal((N, 3, 14, 14))
    _close(btd.btd_to_dense(torch.tensor(S)), jbtd.btd_to_dense(jnp.asarray(S)), 0)
    a = rng.standard_normal((N, 7, 7))
    M = a @ np.swapaxes(a, -1, -2) + 7 * np.eye(7)
    b = rng.standard_normal((N, 7))
    _close(smallmat.gj_inverse(torch.tensor(M)), jsmall.gj_inverse(jnp.asarray(M)), 1e-12)
    _close(smallmat.gj_solve_vec(torch.tensor(M), torch.tensor(b)),
           jsmall.gj_solve_vec(jnp.asarray(M), jnp.asarray(b)), 1e-12)


def test_merit_functions_match_jax(problem):
    xu, xs, ee = problem
    dz = 0.1 * np.random.default_rng(6).standard_normal((N, 21))
    jm, tm = jax_iiwa14(dtype=jnp.float64), iiwa14(torch.float64, device="cpu")
    for cost_kw, it, wrap in (({}, 0, False), ({"mode": "joint"}, 1, True)):
        jc, tc = JCostConfig(**cost_kw), CostConfig(**cost_kw)
        goal = ee if tc.mode == "ee" else xu[:, :14]
        mj, aj = jax.jit(lambda a, b, c, g: jmerit.line_search_merits(
            jm, jc, a, b, c, g, 10.0, DT, integrator_type=it,
            include_zero=True, angle_wrap=wrap))(
                jnp.asarray(xu), jnp.asarray(dz), jnp.asarray(xs), jnp.asarray(goal))
        mt, at = merit.line_search_merits(
            tm, tc, torch.tensor(xu), torch.tensor(dz), torch.tensor(xs),
            torch.tensor(goal), 10.0, DT, integrator_type=it,
            include_zero=True, angle_wrap=wrap)
        _close(mt, mj, 1e-12)
        _close(at, aj, 0)
    _close(merit.merit_function(tm, CostConfig(), torch.tensor(xu), torch.tensor(xs),
                                torch.tensor(ee), 10.0, DT, include_x0=False),
           jax.jit(lambda a, c, g: jmerit.merit_function(
               jm, JCostConfig(), a, c, g, 10.0, DT, include_x0=False))(
                   jnp.asarray(xu), jnp.asarray(xs), jnp.asarray(ee)), 1e-12)
    _, at = merit.line_search_merits(tm, CostConfig(), torch.tensor(xu),
                                     torch.tensor(dz), torch.tensor(xs),
                                     torch.tensor(ee), 10.0, DT, num_alphas=3)
    assert at.tolist() == [-1.0, -0.5, -0.25]


def test_cost_config_is_the_reference_config():
    """The port runs on the JAX package's numpy-only config, field for field."""
    assert dataclasses.asdict(CostConfig.for_knots(64)) == dataclasses.asdict(
        JCostConfig.for_knots(64))
