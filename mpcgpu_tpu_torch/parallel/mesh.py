"""Knot meshes: the collectives of the knot-sharded solves.

Port of ``mpcgpu_tpu/parallel/mesh.py``.  The JAX package shards the horizon
over the ``knot`` axis of a device Mesh and runs each solve's body under
``shard_map``.  Here that body (``parallel/pcg_sharded.py``,
``parallel/sqp_sharded.py``) is written once against a mesh object: every
local tensor carries a leading shard axis (n_local, L, ...), the shard's
contiguous slab of L knots, and the mesh provides the three collectives the
body needs:

  * ``send_right(x)``: every shard receives its LEFT neighbour's x (the ring
    ``ppermute`` i -> i + 1);
  * ``send_left(x)``: every shard receives its RIGHT neighbour's x;
  * ``psum(x)``: the sum of x over all shards, on every shard.

``KnotMesh(n)`` is a virtual mesh on one device, the counterpart of the JAX
suite's virtual CPU devices: all n shards are local, a send is a roll of
the shard axis and psum a sum over it (deterministic, in one order for a
given shape).  ``parallel/distributed.py::DistKnotMesh`` holds one shard per
process of a ``torch.distributed`` group.  Both count their collectives
(``n_psum``, ``n_send``), which is how the tests hold the pipelined PCG to
one psum and one two-way exchange per iteration.

The JAX mesh's ``instance`` axis (independent problems over devices) is not
ported: ``make_mesh(n_instance > 1)`` raises.
"""

from __future__ import annotations

import torch


class KnotMesh:
    """All ``n_shard`` knot shards on one device (module docstring)."""

    def __init__(self, n_shard: int):
        if n_shard < 1:
            raise ValueError(f"a knot mesh needs >= 1 shard, got {n_shard}")
        self.size = n_shard        # shards in the whole mesh
        self.n_local = n_shard     # shards held here
        self.n_psum = 0
        self.n_send = 0

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
    """A virtual knot mesh of ``n_knot`` shards on one device, the port of
    the JAX ``make_mesh(n_instance, n_knot)``."""
    if n_instance != 1:
        raise NotImplementedError(
            "make_mesh(n_instance > 1): the instance axis (the instance-"
            "sharded batched solve, batched_fused.py:576-621) is not ported "
            "yet; see ROADMAP.md queue 1, the instance axis (items 9 and 10, "
            "last)")
    return KnotMesh(n_knot)
