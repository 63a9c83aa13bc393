"""The port's knot-sharded SQP against the JAX package on the CPU, at f64.

``sqp_solve_sharded`` (unfused, and fused: K9a -> K10a -> K9b -> K9c, each
its plain version on CPU tensors) on ``KnotMesh(4)`` and ``KnotMesh(8)`` is
held to the JAX single-device ``sqp_solve(linsys="pcg")``, as
tests/test_parallel.py holds the JAX sharded solve: identical ``pcg_iters``
and ``ls_alpha_idx``, xu within 1e-8.  The jacobi and no-preconditioner
routes are held to the JAX single-device solve too (the JAX package's own
sharded tests of those two fail).  Trace 0_0 rows 350-381 (calm: the PCG
exits before its cap).  The slab kernels' plain versions are held to the
JAX functions in tests/test_torch_slab_kernels.py."""

import dataclasses

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
from mpcgpu_tpu_torch.parallel import KnotMesh, sqp_solve_sharded
from mpcgpu_tpu_torch.solver.sqp import sqp_solve
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N = 32
START = 350
DT = 1.0 / 64.0
RHO = 1e-3
SQP = dict(max_iter=3)
PCG = dict(max_iter=80, exit_tol=1e-7)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[START:START + N] + 0.01 * rng.standard_normal((N, 21))
    return xu, xu[0, :14].copy(), load_eepos_traj("0_0")[START:START + N]


_JAX = {}


def _jax_solve(problem, precond="stair"):
    if precond not in _JAX:
        xu, xs, ee = problem
        jm = jax_iiwa14(dtype=jnp.float64)
        pcg = JPCGConfig(**dict(PCG, max_iter=_cap(precond)), preconditioner=precond)
        _JAX[precond] = jax.jit(lambda a, lam, b, g: jax_sqp_solve(
            jm, JCostConfig.for_knots(N), JSQPConfig(**SQP), pcg, a, lam, b, g,
            RHO, DT, linsys="pcg"))(jnp.asarray(xu), jnp.zeros((N, 14)),
                                    jnp.asarray(xs), jnp.asarray(ee))
    return _JAX[precond]


def _cap(precond):
    """The PCG cap: without a preconditioner, CG on this system (cond ~1e5)
    amplifies the rounding of its reduction order chaotically past ~60
    iterations even at f64 (the port's single-device and sharded solves
    differ by 4e-14 at a cap of 40, 2e-3 at 80 and 0.2 at 300, all at the
    cap), so that route is held at 40 iterations."""
    return 40 if precond == "none" else PCG["max_iter"]


def _port_args(problem, precond="stair", terminal=True):
    xu, xs, ee = problem
    cost = dataclasses.replace(CostConfig.for_knots(N),
                               terminal_at_last_state=terminal)
    return (iiwa14(torch.float64, device="cpu"), cost, SQPConfig(**SQP),
            PCGConfig(**dict(PCG, max_iter=_cap(precond)), preconditioner=precond),
            torch.tensor(xu),
            torch.zeros((N, 14), dtype=torch.float64), torch.tensor(xs),
            torch.tensor(ee), RHO, DT)


def _check(got, ref):
    np.testing.assert_array_equal(got.pcg_iters.numpy(), np.asarray(ref.pcg_iters))
    np.testing.assert_array_equal(got.ls_alpha_idx.numpy(),
                                  np.asarray(ref.ls_alpha_idx))
    assert int(got.sqp_iters) == int(ref.sqp_iters)
    for key in ("xu", "lam"):
        np.testing.assert_allclose(np.asarray(getattr(got, key)),
                                   np.asarray(getattr(ref, key)), rtol=0,
                                   atol=1e-8, err_msg=key)


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("fused", [False, True])
def test_sqp_sharded_matches_jax(problem, fused, shards):
    ref = _jax_solve(problem)
    assert 0 < int(np.asarray(ref.pcg_iters).min()) < PCG["max_iter"]
    got = sqp_solve_sharded(*_port_args(problem), KnotMesh(shards), fused=fused)
    _check(got, ref)


@pytest.mark.parametrize("fused,shards", [(True, 4), (False, 32)])
def test_terminal_quirk_across_shards(problem, fused, shards):
    """The reference's terminal cost at x_{N-2}: in the fused slab (K9a's
    runtime last flag) and, at one knot per shard, from the left
    neighbour's row; against the port's single-device solve, whose quirk is
    held to the JAX build_kkt in tests/test_torch_schur_pcg.py."""
    args = _port_args(problem, terminal=False)
    got = sqp_solve_sharded(*args, KnotMesh(shards), fused=fused)
    _check(got, sqp_solve(*args, linsys="pcg"))


@pytest.mark.parametrize("precond", ["jacobi", "none"])
def test_other_preconditioners(problem, precond):
    ref = _jax_solve(problem, precond)
    got = sqp_solve_sharded(*_port_args(problem, precond), KnotMesh(8))
    _check(got, ref)


def test_iter_budget(problem):
    """iter_budget caps the sharded solve as it caps sqp_solve."""
    args = _port_args(problem)
    got = sqp_solve_sharded(*args, KnotMesh(4), iter_budget=1, fused=True)
    ref = sqp_solve(*args, linsys="pcg", iter_budget=1)
    assert int(got.sqp_iters) == 1 and got.pcg_iters.tolist()[1:] == [-1, -1]
    assert got.pcg_iters.tolist() == ref.pcg_iters.tolist()
    np.testing.assert_allclose(got.xu.numpy(), ref.xu.numpy(), rtol=0, atol=1e-8)
    assert got.pcg_iters[0] == int(np.asarray(_jax_solve(problem).pcg_iters)[0])


def test_pcg_methods_of_the_route(problem):
    """"auto" resolves as in the JAX package: to the s-step "ca_slab" on the
    fused route when a slab holds its 2s+1 halo (L = 16 here: one psum per
    outer step, so fewer than the per-iteration forms' one per CG
    iteration), and "ca" below that width (L = 4) falls back to
    "pipelined"; both give the JAX solve's counts and choices."""
    args = _port_args(problem)
    ref = _jax_solve(problem)
    mesh = KnotMesh(2)
    _check(sqp_solve_sharded(*args, mesh, fused=True), ref)
    assert 0 < mesh.n_psum < 2 * (PCG["max_iter"] + 1)
    _check(sqp_solve_sharded(*args, KnotMesh(8), pcg_method="ca"), ref)
    with pytest.raises(ValueError, match="stair"):
        sqp_solve_sharded(*_port_args(problem, "jacobi"), KnotMesh(8), fused=True)
