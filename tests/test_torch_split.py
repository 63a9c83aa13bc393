"""The split SQP routes of the port against the JAX package on the CPU.

On CPU tensors the wrappers of K5 (build_kkt_cuda), K2' (pcg_solve_cuda) and
K6 (compute_dz_cuda) run their plain versions; those are held against the
JAX functions build_kkt, pcg_solve and compute_dz at f64, and the routes
fused=False and fused_dz=False of sqp_solve against the JAX
sqp_solve(linsys="pcg")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.ops import pcg as jpcg
from mpcgpu_tpu.ops import schur as jschur
from mpcgpu_tpu.solver import kkt as jkkt
from mpcgpu_tpu.solver.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.ops.pcg_cuda import compute_dz_cuda, pcg_solve_cuda
from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_cuda, build_kkt_schur
from mpcgpu_tpu_torch.solver.sqp import sqp_solve
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

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
    return xu, xu[0, :14].copy(), load_eepos_traj("0_0")[:N]


@pytest.fixture(scope="module")
def jax_blocks(problem):
    """JAX build_kkt + form_schur_system (stair) at f64."""
    xu, xs, ee = problem
    jm, jc = jax_iiwa14(dtype=jnp.float64), JCostConfig.for_knots(N)
    return jax.jit(lambda a, b, g: _kkt_schur(jm, jc, a, b, g))(
        jnp.asarray(xu), jnp.asarray(xs), jnp.asarray(ee))


def _kkt_schur(jm, jc, xu, xs, ee):
    kkt = jkkt.build_kkt(jm, jc, xu, xs, ee, DT, 0, False)
    return kkt, jschur.form_schur_system(kkt, RHO, "stair")


def test_kkt_blocks_k5_matches_jax(problem):
    """K5's plain version (through build_kkt_cuda) == JAX build_kkt, per
    block, within 1e-10 of its scale, with the options the default route
    leaves out (semi-implicit Euler, angle wrap, the x_{N-2} terminal cost;
    the default ones run in the SQP routes below)."""
    integrator_type, wrap, terminal_at_last = 1, True, False
    xu, xs, ee = problem
    jm = jax_iiwa14(dtype=jnp.float64)
    jc = JCostConfig(r_cost=1e-4, terminal_at_last_state=terminal_at_last)
    ref = jax.jit(lambda a, b, g: jkkt.build_kkt(jm, jc, a, b, g, DT,
                                                 integrator_type, wrap))(
        jnp.asarray(xu), jnp.asarray(xs), jnp.asarray(ee))
    got = build_kkt_cuda(iiwa14(torch.float64, device="cpu"),
                         CostConfig(r_cost=1e-4, terminal_at_last_state=terminal_at_last),
                         torch.tensor(xu), torch.tensor(xs), torch.tensor(ee), DT,
                         integrator_type, wrap)
    for f in ("Q", "q", "R", "r", "A", "B", "c"):
        _close(getattr(got, f), getattr(ref, f), 1e-10)


@pytest.mark.parametrize("criterion,tol,rtol", [("eta", 1e-8, 1e-10),
                                                ("rnorm", 1e-6, 1e-8)])
def test_pcg_k2_no_epilogue_matches_jax(jax_blocks, criterion, tol, rtol):
    """K2' plain version (through pcg_solve_cuda) == JAX pcg_solve: the same
    iteration count and exit flag, lam within 1e-10 of its scale (1e-8 for
    the longer rnorm solve: the rounding of the two packages' S p grows with
    the iterations on this ill-conditioned system, measured 2.2e-9)."""
    _, sch = jax_blocks
    t = lambda a: torch.tensor(np.asarray(a))
    lam0 = np.zeros((N, 14))
    ref = jpcg.pcg_solve(sch.S, sch.Pinv, sch.gamma, jnp.asarray(lam0),
                         max_iter=167, exit_tol=tol, exit_criterion=criterion)
    got = pcg_solve_cuda(t(sch.S), t(sch.Pinv), t(sch.gamma), t(lam0),
                         max_iter=167, exit_tol=tol, exit_criterion=criterion)
    assert int(got.iters) == int(ref.iters) < 167
    assert bool(got.converged) == bool(ref.converged)
    _close(got.lam, ref.lam, rtol)


def test_pcg_k2_no_epilogue_refuses_five_bands():
    S = torch.zeros((4, 3, 14, 14), dtype=torch.float64)
    P5 = torch.zeros((4, 5, 14, 14), dtype=torch.float64)
    with pytest.raises(ValueError, match="3-band"):
        pcg_solve_cuda(S, P5, torch.zeros((4, 14)), torch.zeros((4, 14)))


def test_dz_k6_matches_jax(problem, jax_blocks):
    """K6's plain version (through compute_dz_cuda, on K1's blocks) == JAX
    compute_dz within 1e-10 of its scale."""
    xu, xs, ee = problem
    kkt, sch = jax_blocks
    lam = np.random.default_rng(3).standard_normal((N, 14))
    ref = jschur.compute_dz(kkt, sch, jnp.asarray(lam))
    t = lambda a: torch.tensor(a)
    sys_ = build_kkt_schur(iiwa14(torch.float64, device="cpu"),
                           CostConfig.for_knots(N), t(xu), t(xs), t(ee), RHO, DT)
    got = compute_dz_cuda(sys_, t(lam), t(xu)[:, 14:], RHO,
                          CostConfig.for_knots(N).r_cost)
    _close(got, ref, 1e-10)


_JAX = {}


def _jax_solve(problem):
    if "ref" not in _JAX:
        xu, xs, ee = problem
        jm = jax_iiwa14(dtype=jnp.float64)
        _JAX["ref"] = jax.jit(lambda a, lam, b, g: jax_sqp_solve(
            jm, JCostConfig.for_knots(N), JSQPConfig(max_iter=3),
            JPCGConfig(max_iter=167, exit_tol=1e-5), a, lam, b, g, RHO, DT,
            linsys="pcg"))(jnp.asarray(xu), jnp.zeros((N, 14)),
                           jnp.asarray(xs), jnp.asarray(ee))
    return _JAX["ref"]


@pytest.mark.parametrize("route", [
    dict(linsys="pcg_cuda", fused=False),           # K5 -> Schur -> K2' -> dz
    dict(linsys="pcg_cuda", fused_dz=False),        # K1 -> K2' -> K6
    dict(linsys="pcg", merit_impl="cuda"),          # K5 -> Schur -> PCG -> K3
])
def test_sqp_split_routes_match_jax_f64(problem, route):
    """Each route's plain versions follow the JAX XLA path iterate for
    iterate at f64: identical PCG counts and line-search choices over 3 SQP
    iterations, xu and lam within 1e-8."""
    ref = _jax_solve(problem)
    xu, xs, ee = problem
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    got = sqp_solve(iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N),
                    SQPConfig(max_iter=3), PCGConfig(max_iter=167, exit_tol=1e-5),
                    t(xu), torch.zeros((N, 14), dtype=torch.float64), t(xs), t(ee),
                    RHO, DT, **route)
    for f in ("pcg_iters", "ls_alpha_idx", "pcg_converged", "sqp_iters", "gave_up"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("xu", "lam"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-8, err_msg=f)
    np.testing.assert_allclose(float(got.merit), float(ref.merit), rtol=1e-10)
