"""Multi-process initialization and the knot mesh across processes.

Port of ``mpcgpu_tpu/parallel/distributed.py`` on ``torch.distributed``:
each process holds one knot shard, the ring sends are point-to-point
(``batch_isend_irecv`` to the ring neighbours) and psum is ``all_reduce``.
CPU tensors go over gloo and CUDA tensors over NCCL: the backend follows the
device the process computes on, and a tensor on the other kind of device
raises instead of falling back.  The knot-sharded solves take a
``DistKnotMesh`` wherever they take a ``KnotMesh``.

Usage, one process per shard (ranks 0 .. n-1), each with the same full
inputs; each returns the same full result.  Like the port's other entry
points, the group defaults to the card (NCCL); a CPU run asks for gloo
with ``device="cpu"``:

    initialize_distributed("localhost:29500", num_processes=n, process_id=rank)
    mesh = make_host_aligned_mesh()
    res = sqp_solve_sharded(..., mesh)
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """``torch.distributed.init_process_group`` over TCP at
    ``coordinator_address`` ("host:port"): NCCL for ``device`` "cuda" (the
    default), gloo for "cpu"; a no-op for one process and no coordinator."""
    if coordinator_address is None and num_processes in (None, 1):
        return
    dist.init_process_group(process_group_backend(device),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def process_group_backend(device) -> str:
    """The backend of a group whose processes compute on ``device``: "nccl"
    for the card, "gloo" for the CPU; anything else raises."""
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return "gloo" if kind == "cpu" else "nccl"


class DistKnotMesh:
    """One knot shard per process of the default process group; local
    tensors have a leading shard axis of 1 (see ``parallel/mesh.py``)."""

    def __init__(self):
        if not dist.is_initialized():
            raise RuntimeError("DistKnotMesh needs torch.distributed to be "
                               "initialized (initialize_distributed)")
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.n_local = 1
        self.backend = dist.get_backend()
        self.n_psum = 0
        self.n_send = 0

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
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to),
                                       dist.P2POp(dist.irecv, out, frm)])
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
        dist.all_reduce(out)
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
        dist.all_gather(parts, local.contiguous())
        return torch.cat(parts).reshape(-1, *local.shape[2:])


def make_host_aligned_mesh(n_knot_per_host: Optional[int] = None) -> DistKnotMesh:
    """The knot mesh over the processes of the group, one shard each (the
    JAX function lays the knot axis over one host's devices and the instance
    axis across hosts; the instance axis is not ported, so the knot axis
    must span the whole group)."""
    mesh = DistKnotMesh()
    if n_knot_per_host not in (None, mesh.size):
        raise NotImplementedError(
            f"a knot axis of {n_knot_per_host} of {mesh.size} processes needs "
            "the instance axis, which is not ported yet; see ROADMAP.md queue "
            "1, the instance axis (items 9 and 10, last)")
    return mesh
