"""The port's batched SQP solve against the JAX package on the CPU.

On CPU tensors the wrappers of K8a (build_kkt_schur_batched), K8b
(pcg_solve_batched), K8c (compute_dz_batched) and the batched K3
(line_search_merits_batched) run their plain versions, loops of the
single-instance plain versions.  They are held per instance against the JAX
XLA functions at f64, and the whole batched solve against
``jax.vmap(sqp_solve(linsys="pcg"))`` (as tests/test_batched_fused.py holds
the JAX batched pipeline), including an instance that gives up and stays
frozen while the others go on."""

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
from mpcgpu_tpu.solver import merit as jmerit
from mpcgpu_tpu.solver.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel import (build_kkt_schur_batched, compute_dz_batched,
                                       line_search_merits_batched,
                                       make_batched_sqp_solver, pcg_solve_batched)
from mpcgpu_tpu_torch.solver.sqp import sqp_solve
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

B, N = 3, 16
DT = 1.0 / 64.0
MU = 10.0
SQP = dict(max_iter=3)
PCG = dict(max_iter=60, exit_tol=1e-8)


def _inputs(give_up: bool = False):
    """B noisy copies of trace 0_0 (numpy seed 0), per-instance rho.  With
    give_up, instance 1's goal is NaN, so its line search fails at once, and
    its rho starts at rho_max, so that failure makes it give up."""
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[:N][None] + 0.02 * rng.standard_normal((B, N, 21))
    ee = np.broadcast_to(load_eepos_traj("0_0")[:N], (B, N, 6)).copy()
    rho = np.array([1e-3, 2e-3, 5e-3])
    if give_up:
        ee[1] = np.nan
        rho[1] = SQPConfig().rho_max
    return xu, np.zeros((B, N, 14)), xu[:, 0, :14].copy(), ee, rho


_JAX = {}


def _jax_batched(give_up: bool):
    if "solve" not in _JAX:
        jm = jax_iiwa14(dtype=jnp.float64)
        jc = JCostConfig.for_knots(N)
        _JAX["solve"] = jax.jit(jax.vmap(
            lambda xu, lam, xs, ee, rho: jax_sqp_solve(
                jm, jc, JSQPConfig(**SQP), JPCGConfig(**PCG), xu, lam, xs, ee,
                rho, DT, linsys="pcg")))
    if give_up not in _JAX:
        _JAX[give_up] = _JAX["solve"](*map(jnp.asarray, _inputs(give_up)))
    return _JAX[give_up]


def _port_batched(give_up: bool, fused=True):
    solve = make_batched_sqp_solver(iiwa14(torch.float64, device="cpu"),
                                    CostConfig.for_knots(N), SQPConfig(**SQP),
                                    PCGConfig(**PCG), DT, fused=fused)
    return solve(*map(torch.tensor, _inputs(give_up)))


@pytest.mark.parametrize("give_up", [False, True])
def test_batched_solve_matches_jax_vmap_f64(give_up):
    """K8 plain, f64, B=3, N=16, 3 SQP iterations, PCG (60, 1e-8): the same
    PCG iterations, line-search choices, SQP iterations and give-ups as the
    vmap of the JAX solve, xu within 1e-8."""
    ref, got = _jax_batched(give_up), _port_batched(give_up)
    for f in ("pcg_iters", "ls_alpha_idx", "pcg_converged", "sqp_iters", "gave_up"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.xu.numpy(), np.asarray(ref.xu), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam), rtol=0,
                               atol=1e-8 * float(np.nanmax(np.abs(ref.lam))))
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(ref.rho), rtol=1e-10)


def test_given_up_instance_stays_frozen():
    """The instance that gives up stops after one iteration with its iterate
    untouched and rho reset; the other instances go on exactly as in the
    run without it."""
    xu0 = torch.tensor(_inputs(True)[0])
    frozen, free = _port_batched(True), _port_batched(False)
    assert frozen.sqp_iters.tolist() == [3, 1, 3]
    assert frozen.gave_up.tolist() == [False, True, False]
    assert frozen.ls_alpha_idx[1].tolist() == [-1, -1, -1]
    assert frozen.pcg_iters[1].tolist()[1:] == [-1, -1]
    assert torch.equal(frozen.xu[1], xu0[1])
    assert float(frozen.rho[1]) == SQPConfig().rho_reset
    for i in (0, 2):
        for f in ("xu", "lam", "rho", "pcg_iters", "ls_alpha_idx"):
            assert torch.equal(getattr(frozen, f)[i], getattr(free, f)[i]), (i, f)


def test_unfused_batched_solver_is_a_loop_of_single_solves():
    """make_batched_sqp_solver(fused=False) equals a loop of single
    unfused solves, and the K8 path (plain here) agrees with it at f64."""
    xu, lam, xs, ee, rho = map(torch.tensor, _inputs())
    model, cost = iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N)
    got = _port_batched(False, fused=False)
    for i in range(B):
        one = sqp_solve(model, cost, SQPConfig(**SQP), PCGConfig(**PCG), xu[i],
                        lam[i], xs[i], ee[i], rho[i], DT, fused=False)
        for f in one._fields:
            assert torch.equal(getattr(got, f)[i], getattr(one, f)), (i, f)
    fused = _port_batched(False, fused=True)
    for f in ("pcg_iters", "ls_alpha_idx", "sqp_iters"):
        assert torch.equal(getattr(fused, f), getattr(got, f)), f
    torch.testing.assert_close(fused.xu, got.xu, rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def jax_blocks():
    """vmap of the JAX XLA functions K8a-c and K3 are held against, f64."""
    xu, lam, xs, ee, rho = map(jnp.asarray, _inputs())
    jm, jc = jax_iiwa14(dtype=jnp.float64), JCostConfig.for_knots(N)

    def one(xu, lam, xs, ee, rho):
        kkt = jkkt.build_kkt(jm, jc, xu, xs, ee, DT)
        sch = jschur.form_schur_system(kkt, rho, "stair")
        res = jpcg.pcg_solve(sch.S, sch.Pinv, sch.gamma, lam, **PCG)
        dz = jschur.compute_dz(kkt, sch, res.lam)
        merits, alphas = jmerit.line_search_merits(jm, jc, xu, dz, xs, ee, MU, DT,
                                                   include_zero=True)
        return sch, res, dz, merits, alphas

    return jax.jit(jax.vmap(one))(xu, lam, xs, ee, rho)


def _close(got, ref, rtol=1e-9):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rtol * max(float(np.abs(ref).max()), 1e-300))


def test_batched_kernels_plain_match_jax_f64(jax_blocks):
    """K8a, K8b, K8c and the batched K3 on CPU tensors (their plain
    versions) against the vmap of build_kkt + form_schur_system, pcg_solve,
    compute_dz and line_search_merits at f64: blocks and solutions within
    1e-9 of their scale per instance, identical PCG iteration counts."""
    sch, res, dz_ref, merits_ref, alphas_ref = jax_blocks
    xu, lam, xs, ee, rho = map(torch.tensor, _inputs())
    model, cost = iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N)
    sys = build_kkt_schur_batched(model, cost, xu, xs, ee, rho, DT)
    for key, ref in (("S", sch.S), ("Pinv", sch.Pinv), ("gamma", sch.gamma),
                     ("Qinv", sch.Qinv)):
        for i in range(B):
            _close(sys[key][i], ref[i])
    lam_b, iters, conv = pcg_solve_batched(sys["S"], sys["Pinv"], sys["gamma"],
                                           lam, **PCG)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(res.iters))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(res.converged))
    dz = compute_dz_batched(sys, lam_b, xu[:, :, 14:], rho, cost.r_cost)
    merits, alphas = line_search_merits_batched(model, cost, xu, dz, xs, ee, MU, DT)
    for i in range(B):
        _close(lam_b[i], res.lam[i])
        _close(dz[i], dz_ref[i])
        _close(merits[i], merits_ref[i])
    np.testing.assert_array_equal(alphas.numpy(), np.asarray(alphas_ref))
