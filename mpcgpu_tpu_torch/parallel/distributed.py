"""Multi-process initialization and the knot mesh across processes.

Port of ``mpcgpu_tpu/parallel/distributed.py`` on ``torch.distributed``:
the processes form an (instance, knot) grid, each holding one knot shard of
one instance group.  A knot axis is ``n_knot_per_host`` consecutive ranks on
a process group of its own: the ring sends are point-to-point
(``batch_isend_irecv`` to the ring neighbours) and psum is ``all_reduce``,
both within it.  The instance axis spans the rest and needs no collective in
the solve: each process solves its own instance slab.
CPU tensors go over gloo and CUDA tensors over NCCL: the backend follows the
device the process computes on, and a tensor on the other kind of device
raises instead of falling back.  The knot-sharded solves take a
``DistKnotMesh`` wherever they take a ``KnotMesh``.

Usage, one process per shard (ranks 0 .. n-1), each with the same full
inputs; a knot-sharded solve returns the same full result on every process
of a knot axis, a batched solve the result of the process's instance slab.
Like the port's other entry points, the group defaults to the card (NCCL); a
CPU run asks for gloo with ``device="cpu"``:

    initialize_distributed("localhost:29500", num_processes=n, process_id=rank)
    mesh = make_host_aligned_mesh()
    res = sqp_solve_sharded(..., mesh)
    mesh = make_host_aligned_mesh(n_knot_per_host=1)   # n instance groups
    res = sqp_solve_batched_fused_sharded(..., mesh)   # this rank's slab
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from mpcgpu_tpu_torch.parallel.mesh import check_instances


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """``torch.distributed.init_process_group`` over TCP at
    ``coordinator_address`` ("host:port"): NCCL for ``device`` "cuda" (the
    default), gloo for "cpu"; a no-op for one process and no coordinator.

    On the card each process takes one card of its host first: its local
    rank, from ``LOCAL_RANK`` where a launcher sets it (``python -m
    torch.distributed.run``), else ``process_id`` modulo the visible
    cards.  That card becomes the process's current device (NCCL puts no
    two ranks on one card, and the port's entry points default to the
    current card) and the group is bound to it."""
    if coordinator_address is None and num_processes in (None, 1):
        return
    backend = process_group_backend(device)
    kw = {}
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None \
            else process_id % torch.cuda.device_count()
        card = torch.device("cuda", index)
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)


def process_group_backend(device) -> str:
    """The backend of a group whose processes compute on ``device``: "nccl"
    for the card, "gloo" for the CPU; anything else raises."""
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return "gloo" if kind == "cpu" else "nccl"


class DistKnotMesh:
    """One knot shard of one instance group per process of the default
    process group: the knot axis is ``n_knot`` consecutive ranks (all of
    them by default), the instance axis the world size / n_knot such runs.
    Local tensors have a leading shard axis of 1 (see ``parallel/mesh.py``).
    ``size`` and ``rank`` are the knot axis's; ``instance`` is this
    process's instance group."""

    def __init__(self, n_knot: Optional[int] = None):
        if not dist.is_initialized():
            raise RuntimeError("DistKnotMesh needs torch.distributed to be "
                               "initialized (initialize_distributed)")
        world, grank = dist.get_world_size(), dist.get_rank()
        n_knot = n_knot or world
        if n_knot < 1 or world % n_knot:
            raise ValueError(f"knot axis {n_knot} must divide the process "
                             f"count {world}")
        self.size = n_knot
        self.rank = grank % n_knot
        self.instance = grank // n_knot
        self.n_instance = world // n_knot
        self.shape = {"instance": self.n_instance, "knot": n_knot}
        self.n_local = 1
        self.backend = dist.get_backend()
        # the global ranks of this knot axis; a group of its own unless it
        # is the whole world (every process creates every group, in order)
        self._ranks = [self.instance * n_knot + k for k in range(n_knot)]
        self.group = None
        if n_knot < world:
            for i in range(self.n_instance):
                g = dist.new_group(list(range(i * n_knot, (i + 1) * n_knot)))
                if i == self.instance:
                    self.group = g
        self.n_psum = 0
        self.n_send = 0

    def instance_slices(self, B: int) -> list:
        """The instance group held here, as a slice of a batch of B: this
        process's B / n_instance consecutive problems."""
        check_instances(B, self.n_instance)
        b = B // self.n_instance
        return [slice(self.instance * b, (self.instance + 1) * b)]

    def _check(self, x):
        want = process_group_backend(x.device)
        if self.backend != want:
            raise ValueError(f"{x.device} tensors go over {want}; this process "
                             f"group runs {self.backend}")

    def _ring(self, x, to: int, frm: int):
        self._check(x)
        x = x.contiguous()
        if self.size == 1:
            return x.clone()
        out = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, self._ranks[to], self.group),
            dist.P2POp(dist.irecv, out, self._ranks[frm], self.group)])
        for req in reqs:
            req.wait()
        return out

    def shard_ids(self, device):
        return torch.full((1,), self.rank, dtype=torch.int64, device=device)

    def send_right(self, x):
        self.n_send += 1
        return self._ring(x, (self.rank + 1) % self.size,
                          (self.rank - 1) % self.size)

    def send_left(self, x):
        self.n_send += 1
        return self._ring(x, (self.rank - 1) % self.size,
                          (self.rank + 1) % self.size)

    def psum(self, x):
        self.n_psum += 1
        self._check(x)
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def scatter(self, full):
        N = full.shape[0]
        if N % self.size:
            raise ValueError(f"N={N} not divisible by {self.size} knot shards")
        L = N // self.size
        return full[self.rank * L:(self.rank + 1) * L][None]

    def gather(self, local):
        self._check(local)
        parts = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        return torch.cat(parts).reshape(-1, *local.shape[2:])


def make_host_aligned_mesh(n_knot_per_host: Optional[int] = None) -> DistKnotMesh:
    """The (instance, knot) mesh over the processes of the group, one shard
    each, with each knot axis within ``n_knot_per_host`` consecutive ranks
    (the whole group by default) and the instance axis across them: the
    JAX function lays the knot axis over one host's devices, where its
    collectives ride the fast links, and the instance axis, which needs no
    collective in the solve, across hosts."""
    return DistKnotMesh(n_knot_per_host)
