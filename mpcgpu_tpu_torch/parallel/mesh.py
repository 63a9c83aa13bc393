"""The (instance, knot) mesh: the collectives of the knot-sharded solves and
the instance groups of the batched ones.

Port of ``mpcgpu_tpu/parallel/mesh.py``.  The JAX package lays a device Mesh
out over two axes: ``instance`` (independent problems, no communication in
the solver) and ``knot`` (the horizon, sharded).  It shards the horizon over
the knot axis and runs each solve's body under ``shard_map``.  Here that body
(``parallel/pcg_sharded.py``, ``parallel/sqp_sharded.py``) is written once
against a mesh object: every local tensor carries a leading shard axis
(n_local, L, ...), the shard's contiguous slab of L knots, and the mesh
provides the three collectives the body needs:

  * ``send_right(x)``: every shard receives its LEFT neighbour's x (the ring
    ``ppermute`` i -> i + 1);
  * ``send_left(x)``: every shard receives its RIGHT neighbour's x;
  * ``psum(x)``: the sum of x over all shards, on every shard.

The instance axis needs no collective: ``instance_slices(B)`` gives the
instance groups held here, the slabs of B / n_instance consecutive problems
that the batched solve and the batched loop run one group at a time
(``parallel/batched_cuda.py::sqp_solve_batched_fused_sharded``,
``sim/mpc.py::simulate_mpc_ondevice_batched(instance_mesh=)``).

``KnotMesh(n_knot, n_instance)`` is a virtual mesh on one device, the
counterpart of the JAX suite's virtual CPU devices: all knot shards and all
instance groups are local, a send is a roll of the shard axis and psum a sum
over it (deterministic, in one order for a given shape).
``parallel/distributed.py::DistKnotMesh`` holds one knot shard and one
instance group per process of a ``torch.distributed`` group.  Both count
their collectives (``n_psum``, ``n_send``), which is how the tests hold the
pipelined PCG to one psum and one two-way exchange per iteration.
"""

from __future__ import annotations

import torch


def check_instances(B: int, n_instance: int) -> None:
    """Raise unless a batch of B problems splits over n_instance groups
    (the JAX ``sqp_solve_batched_fused_sharded``'s message)."""
    if B % n_instance:
        raise ValueError(f"batch {B} not divisible by {n_instance} "
                         "'instance'-axis devices")


class KnotMesh:
    """All ``n_shard`` knot shards and all ``n_instance`` instance groups
    on one device (module docstring)."""

    def __init__(self, n_shard: int, n_instance: int = 1):
        if n_shard < 1 or n_instance < 1:
            raise ValueError(f"a mesh needs >= 1 knot shard and instance group, "
                             f"got {n_shard} and {n_instance}")
        self.size = n_shard        # shards in the whole mesh
        self.n_local = n_shard     # shards held here
        self.n_instance = n_instance
        self.shape = {"instance": n_instance, "knot": n_shard}
        self.n_psum = 0
        self.n_send = 0

    def instance_slices(self, B: int) -> list:
        """The instance groups held here, as slices of a batch of B: all
        n_instance of them, B / n_instance problems each."""
        check_instances(B, self.n_instance)
        b = B // self.n_instance
        return [slice(g * b, (g + 1) * b) for g in range(self.n_instance)]

    def shard_ids(self, device):
        """The global index of each local shard, (n_local,) int64."""
        return torch.arange(self.size, device=device)

    def send_right(self, x):
        self.n_send += 1
        return torch.roll(x, 1, dims=0)

    def send_left(self, x):
        self.n_send += 1
        return torch.roll(x, -1, dims=0)

    def psum(self, x):
        self.n_psum += 1
        return x.sum(dim=0, keepdim=True).expand_as(x)

    def scatter(self, full):
        """The local slabs (n_local, L, ...) of a full (N, ...) array."""
        N = full.shape[0]
        if N % self.size:
            raise ValueError(f"N={N} not divisible by {self.size} knot shards")
        return full.reshape(self.size, N // self.size, *full.shape[1:])

    def gather(self, local):
        """The full (N, ...) array from every shard's slab."""
        return local.reshape(-1, *local.shape[2:])


def make_mesh(n_instance: int = 1, n_knot: int = 1) -> KnotMesh:
    """A virtual (instance, knot) mesh on one device, ``n_instance`` groups
    of a batch by ``n_knot`` shards of a horizon: the port of the JAX
    ``make_mesh(n_instance, n_knot)``."""
    return KnotMesh(n_knot, n_instance)


def shard_batched_problem(mesh, xu, lam, xs, ee_goal, rho):
    """Place a batched problem (xu, lam, ee_goal (B, N, ...); xs, rho (B,
    ...)) on the (instance, knot) mesh: the batch axis over ``instance``,
    the knot axis over ``knot``.  Port of the JAX function of this name.

    The port's meshes cut their slabs from whole tensors: on one device the
    instance groups and knot shards are views (``instance_slices``,
    ``scatter``), and across processes every process holds the same whole
    problem and cuts its own slabs (``DistKnotMesh``).  So placing is
    checking: B must split over the instance axis and N over the knot axis,
    and the five tensors must agree in B and N; they are returned as they
    are."""
    B, N = xu.shape[:2]
    check_instances(B, mesh.shape["instance"])
    if N % mesh.shape["knot"]:
        raise ValueError(f"N={N} not divisible by {mesh.shape['knot']} knot shards")
    for name, t, lead in (("lam", lam, (B, N)), ("ee_goal", ee_goal, (B, N)),
                          ("xs", xs, (B,)), ("rho", rho, (B,))):
        if tuple(t.shape[:len(lead)]) != lead:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected leading "
                             f"{lead} as xu's")
    return xu, lam, xs, ee_goal, rho
