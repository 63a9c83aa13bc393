"""The port's knot-sharded PCG against the JAX package on the CPU.

The Schur system of the IIWA at N = 32 comes from the JAX XLA functions
(``build_kkt`` + ``form_schur_system``, f64) on trace 0_0 rows 350-381 with
numpy noise; those rows are calm (rows 16-26 of the trace run away, and a
system over them needs more than 300 CG steps to converge).  The port's
``pcg_solve_sharded`` on ``KnotMesh(8)`` (L = 4) runs each method, the
pipelined slab method through K10a's plain version
(``ops/pcg_slab.py::pcg_slab_step``), and is held against the JAX
single-device ``pcg_solve`` and the JAX ``pcg_solve_sharded(method=
"pipelined")`` on its virtual 8-device mesh, with the JAX tests' own
allowances (tests/test_parallel.py): classic's iteration count equal,
pipelined's within one; lam within 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.ops.pcg import pcg_solve as jax_pcg_solve
from mpcgpu_tpu.ops.schur import form_schur_system as jax_form_schur
from mpcgpu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpcgpu_tpu.parallel.pcg_sharded import pcg_solve_sharded as jax_pcg_sharded
from mpcgpu_tpu.solver.kkt import build_kkt as jax_build_kkt
from mpcgpu_tpu_torch.parallel import (KnotMesh, make_mesh, pcg_solve_sharded,
                                       pcg_solve_two_slab)
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N = 32
START = 350
DT = 1.0 / 64.0
MAX_ITER = 300
TOL = {"eta": 1e-12, "rnorm": 1e-7}


@pytest.fixture(scope="module")
def system():
    """(S, Pinv, gamma) as numpy f64, from the JAX functions (jitted: the
    eager calls take a minute)."""
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[START:START + N] + 0.01 * rng.standard_normal((N, 21))
    ee = load_eepos_traj("0_0")[START:START + N]
    model, cost = jax_iiwa14(dtype=jnp.float64), JCostConfig.for_knots(N)
    sch = jax.jit(lambda xu, xs, ee: jax_form_schur(
        jax_build_kkt(model, cost, xu, xs, ee, DT), 1e-3))(
            jnp.asarray(xu), jnp.asarray(xu[0, :14]), jnp.asarray(ee))
    return tuple(np.asarray(a) for a in (sch.S, sch.Pinv, sch.gamma))


@pytest.fixture(scope="module")
def jax_refs(system):
    """The JAX single-device and 8-shard pipelined solves, per criterion."""
    S, P, g = (jnp.asarray(a) for a in system)
    lam0 = jnp.zeros((N, 14), jnp.float64)
    mesh = jax_make_mesh(1, 8)
    out = {}
    for crit, tol in TOL.items():
        kw = dict(max_iter=MAX_ITER, exit_tol=tol, exit_criterion=crit)
        out[crit] = (jax_pcg_solve(S, P, g, lam0, **kw),
                     jax.jit(lambda *a: jax_pcg_sharded(
                         *a, mesh, method="pipelined", **kw))(S, P, g, lam0))
    return out


def _port(system, method, crit, mesh=None, n=N, max_iter=MAX_ITER, tol=None):
    S, P, g = (torch.tensor(a[:n]) for a in system)
    mesh = KnotMesh(8) if mesh is None else mesh
    return pcg_solve_sharded(S, P, g, torch.zeros((n, 14), dtype=torch.float64),
                             mesh, max_iter=max_iter,
                             exit_tol=TOL[crit] if tol is None else tol,
                             exit_criterion=crit, method=method)


@pytest.mark.parametrize("crit", ["eta", "rnorm"])
@pytest.mark.parametrize("method", ["classic", "pipelined", "pipelined_slab"])
def test_sharded_pcg_matches_jax(system, jax_refs, method, crit):
    single, sharded = jax_refs[crit]
    got = _port(system, method, crit)
    assert bool(got.converged) and bool(single.converged) and bool(sharded.converged)
    n_single = int(single.iters)
    assert 0 < n_single < MAX_ITER
    if method == "classic":
        assert int(got.iters) == n_single
    else:
        assert abs(int(got.iters) - n_single) <= 1
        assert abs(int(got.iters) - int(sharded.iters)) <= 1
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(single.lam), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(sharded.lam), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("method,per_iter", [("classic", (4, 2)),
                                             ("pipelined", (2, 1)),
                                             ("pipelined_slab", (2, 1))])
def test_collectives_per_iteration(system, method, per_iter):
    """The collective budget of tests/test_parallel.py's
    test_sharded_pcg_pipelined_collective_budget, counted by the mesh:
    per CG iteration classic sends 4 halo rows and sums 2 dots, the
    pipelined forms exchange one two-row packet each way (2 sends) and sum
    once.  The loop runs its max_iter iterations (masked after the exit),
    so the difference between two caps counts whole iterations."""
    counts = {}
    for cap in (3, 7):
        mesh = KnotMesh(8)
        _port(system, method, "eta", mesh=mesh, max_iter=cap, tol=0.0)
        counts[cap] = (mesh.n_send, mesh.n_psum)
    sends, psums = (b - a for a, b in zip(counts[3], counts[7]))
    assert (sends / 4, psums / 4) == per_iter


def test_narrow_slab_falls_back_to_classic(system):
    """At one knot per shard (N = 8 on 8 shards) the pipelined forms fall
    back to classic, as the JAX pcg_solve_sharded does: the same result bit
    for bit and classic's collectives."""
    ref_mesh = KnotMesh(8)
    ref = _port(system, "classic", "eta", mesh=ref_mesh, n=8, max_iter=40)
    assert int(ref.iters) > 0
    for method in ("pipelined", "pipelined_slab"):
        mesh = KnotMesh(8)
        got = _port(system, method, "eta", mesh=mesh, n=8, max_iter=40)
        assert torch.equal(got.lam, ref.lam) and int(got.iters) == int(ref.iters)
        assert (mesh.n_send, mesh.n_psum) == (ref_mesh.n_send, ref_mesh.n_psum)


def test_two_slab_and_mesh_sizes(system, jax_refs):
    """pcg_solve_two_slab is the pipelined slab method on KnotMesh(2), and
    every mesh size that divides N gives the single-device solve."""
    single = jax_refs["eta"][0]
    two = pcg_solve_two_slab(*(torch.tensor(a) for a in system),
                             torch.zeros((N, 14), dtype=torch.float64),
                             max_iter=MAX_ITER, exit_tol=TOL["eta"])
    assert torch.equal(two.lam, _port(system, "pipelined_slab", "eta",
                                      mesh=KnotMesh(2)).lam)
    for shards in (1, 2, 4, 16):
        got = _port(system, "pipelined_slab", "eta", mesh=make_mesh(1, shards))
        assert abs(int(got.iters) - int(single.iters)) <= 1
        np.testing.assert_allclose(got.lam.numpy(), np.asarray(single.lam),
                                   rtol=0, atol=1e-8)


def test_unported_methods_and_meshes_raise(system, jax_refs):
    """The s-step methods are ported: at L = 16 (2 shards, s = 4) they run
    and converge to the single-device solve (tests/test_torch_ca_pcg.py
    holds them to the JAX package); so is the instance axis: a solve over
    the knot axis of an (instance, knot) mesh is the knot mesh's bit for
    bit.  A mesh that does not divide N raises."""
    single = jax_refs["eta"][0]
    for method in ("ca", "ca_slab"):
        got = _port(system, method, "eta", mesh=KnotMesh(2))
        assert bool(got.converged) and int(got.iters) < MAX_ITER
        assert abs(int(got.iters) - int(single.iters)) <= 4
        np.testing.assert_allclose(got.lam.numpy(), np.asarray(single.lam),
                                   rtol=0, atol=1e-7)
    mesh, knots = make_mesh(n_instance=2, n_knot=4), KnotMesh(4)
    assert mesh.shape == {"instance": 2, "knot": 4}
    got, ref = (_port(system, "pipelined", "eta", mesh=m) for m in (mesh, knots))
    assert torch.equal(got.lam, ref.lam) and int(got.iters) == int(ref.iters)
    assert (mesh.n_psum, mesh.n_send) == (knots.n_psum, knots.n_send) != (0, 0)
    with pytest.raises(ValueError, match="divisible"):
        _port(system, "pipelined", "eta", mesh=KnotMesh(5))
