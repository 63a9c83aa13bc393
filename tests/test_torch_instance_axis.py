"""The instance axis of the port's meshes on the CPU: ``make_mesh(n_instance,
n_knot)``, ``shard_batched_problem``, ``sqp_solve_batched_fused_sharded``
and ``make_batched_sqp_solver(mesh=)``.

On one device the instance axis is virtual: each instance group runs the
batched solve on its own slab, one group after another, so at f64 the
instance-sharded solve equals the unsharded one bit for bit (as
tests/test_batched_fused.py:194 holds the JAX pair, which XLA lowers to
rounding-level agreement).  Both are held to the JAX oracle, the vmap of
``sqp_solve(linsys="pcg")``, at test_torch_batched.py's tolerances, and a
batched solve over a (4, 2) mesh mirrors tests/test_parallel.py:307."""

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
from mpcgpu_tpu_torch.parallel import (KnotMesh, make_batched_sqp_solver,
                                       make_mesh, shard_batched_problem,
                                       sqp_solve_batched_fused,
                                       sqp_solve_batched_fused_sharded,
                                       sqp_solve_sharded)
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

B, N = 4, 16
DT = 1.0 / 64.0
SQP = dict(max_iter=2)
PCG = dict(max_iter=60, exit_tol=1e-8)


def _inputs(b=B):
    """b noisy copies of trace 0_0 from the calm row 350 (numpy seed 0),
    rho 1e-3 x (1, 2, 3, 4, ...)."""
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[350:350 + N][None] + 0.02 * rng.standard_normal((b, N, 21))
    ee = np.broadcast_to(load_eepos_traj("0_0")[350:350 + N], (b, N, 6)).copy()
    return xu, np.zeros((b, N, 14)), xu[:, 0, :14].copy(), ee, 1e-3 * (1 + np.arange(b))


def _args():
    return (iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N),
            SQPConfig(**SQP), PCGConfig(**PCG), *map(torch.tensor, _inputs()), DT)


@pytest.fixture(scope="module")
def solves():
    """The unsharded batched solve and the one over make_mesh(n_instance=2)."""
    args = _args()
    ref = sqp_solve_batched_fused(*args)
    got = sqp_solve_batched_fused_sharded(*args, make_mesh(n_instance=2),
                                          inst_per_prog=2)
    return ref, got


def test_make_mesh_carries_both_axes():
    mesh = make_mesh(n_instance=4, n_knot=2)
    assert mesh.shape == {"instance": 4, "knot": 2}
    assert (mesh.size, mesh.n_local, mesh.n_instance) == (2, 2, 4)
    assert mesh.instance_slices(8) == [slice(0, 2), slice(2, 4), slice(4, 6),
                                       slice(6, 8)]
    assert make_mesh().shape == {"instance": 1, "knot": 1}
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 'instance'"):
        mesh.instance_slices(6)
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh(n_instance=0)


def test_shard_batched_problem_checks_and_places():
    """On one device the problem's tensors are the mesh's views: returned as
    they are.  A batch or horizon the mesh does not divide raises, as does
    a tensor of another batch."""
    xu, lam, xs, ee, rho = map(torch.tensor, _inputs())
    mesh = make_mesh(n_instance=2, n_knot=4)
    out = shard_batched_problem(mesh, xu, lam, xs, ee, rho)
    assert all(a is b for a, b in zip(out, (xu, lam, xs, ee, rho)))
    with pytest.raises(ValueError, match="batch 4 not divisible by 3"):
        shard_batched_problem(make_mesh(3, 1), xu, lam, xs, ee, rho)
    with pytest.raises(ValueError, match="N=16 not divisible by 3 knot shards"):
        shard_batched_problem(make_mesh(1, 3), xu, lam, xs, ee, rho)
    with pytest.raises(ValueError, match="rho"):
        shard_batched_problem(mesh, xu, lam, xs, ee, rho[:2])


def test_instance_sharded_solve_equals_unsharded_f64(solves):
    """Every field of every instance bit for bit (each group's slab runs the
    same per-instance arithmetic; a stopped group only skips iterations
    that would leave its frozen instances as they are)."""
    ref, got = solves
    for f in ref._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_instance_sharded_solve_matches_jax_f64(solves):
    """Against the vmap of the JAX sqp_solve(linsys="pcg") per instance: the
    same PCG iterations and line-search choices, xu within 1e-8."""
    jm, jc = jax_iiwa14(dtype=jnp.float64), JCostConfig.for_knots(N)
    ref = jax.jit(jax.vmap(lambda xu, lam, xs, ee, rho: jax_sqp_solve(
        jm, jc, JSQPConfig(**SQP), JPCGConfig(**PCG), xu, lam, xs, ee, rho, DT,
        linsys="pcg")))(*map(jnp.asarray, _inputs()))
    _, got = solves
    for f in ("pcg_iters", "ls_alpha_idx", "sqp_iters"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.xu.numpy(), np.asarray(ref.xu), rtol=0, atol=1e-8)


def test_batched_solve_over_an_instance_knot_mesh():
    """tests/test_parallel.py:307 on the port: B = 4 copies of one problem
    placed on a (4, 2) mesh, solved by make_batched_sqp_solver over it:
    finite, the replicated instances equal, each instance the unsharded
    solve's bit for bit (fused and looped).  The knot-sharded SQP takes the
    same mesh: its knot axis runs the solve as a KnotMesh(2) does."""
    xu, lam, xs, ee, rho = map(torch.tensor, _inputs(1))
    rep = lambda t: t.expand(B, *t.shape[1:]).contiguous()
    batch = tuple(map(rep, (xu, lam, xs, ee, rho)))
    mesh = make_mesh(n_instance=4, n_knot=2)
    placed = shard_batched_problem(mesh, *batch)
    model, cost = iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N)
    cfg = (SQPConfig(max_iter=2), PCGConfig(max_iter=50, exit_tol=1e-6), DT)
    for fused in (True, False):
        got = make_batched_sqp_solver(model, cost, *cfg, fused=fused, mesh=mesh)(*placed)
        ref = make_batched_sqp_solver(model, cost, *cfg, fused=fused)(*batch)
        assert bool(torch.isfinite(got.xu).all())
        assert all(torch.equal(got.xu[0], got.xu[i]) for i in range(1, B))
        for f in ref._fields:
            assert torch.equal(getattr(got, f), getattr(ref, f)), (fused, f)
    one = (model, cost, *cfg[:2], xu[0], lam[0], xs[0], ee[0], 1e-3, DT)
    a = sqp_solve_sharded(*one, mesh, fused=False, pcg_method="pipelined")
    b = sqp_solve_sharded(*one, KnotMesh(2), fused=False, pcg_method="pipelined")
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_instance_axis_name_and_ignored_packing():
    """inst_per_prog (the TPU's lane packing) is accepted and ignored; an
    axis the mesh lacks raises."""
    args = _args()
    mesh = make_mesh(n_instance=4)
    a = sqp_solve_batched_fused_sharded(*args, mesh, inst_per_prog=1)
    b = sqp_solve_batched_fused_sharded(*args, mesh)
    assert torch.equal(a.xu, b.xu)
    with pytest.raises(ValueError, match="'scenario' axis"):
        sqp_solve_batched_fused_sharded(*args, mesh, instance_axis="scenario")
