"""K10a: one pipelined CG step on every knot shard's slab, the per-shard
compute of the knot-sharded PCG (``parallel/pcg_sharded.py``,
``method="pipelined_slab"``).

Port of ``mpcgpu_tpu/ops/pcg_pallas.py::pcg_slab_step_pallas``; the CUDA
kernel is ``csrc/pcg_slab.cu`` and the plain version
``ops/pcg_slab.py::pcg_slab_step`` (the state and the step are described
there).  ``pcg_slab_step_cuda`` runs the plain version for CPU tensors and
the kernel, one thread-block cluster per shard laid out by
``slab_cluster_plan(L, nx=nx)``, for CUDA tensors, from the library built
for nq = nx / 2.
"""

from __future__ import annotations

from typing import NamedTuple

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.ops.pcg_cuda import require_nx
from mpcgpu_tpu_torch.ops.pcg_slab import pcg_slab_step

# csrc/pcg_slab.cu's limits: the largest cluster (16 is above the portable
# 8), the most threads of a CTA; the knots a CTA aims at, and the shared
# memory a block may use on an H100
SLAB_MAX_CLUSTER = 16
SLAB_MAX_THREADS = 512
SLAB_TARGET_KNOTS = 4
SMEM_LIMIT = 232448


def slab_knot_stride(nx: int = 14) -> int:
    """SLAB_KNOT_STRIDE of csrc/pcg_slab.cu: one knot's three nx x nx
    blocks in a CTA's shared memory, floats, padded to the least stride
    congruent to nx^2 mod 32, so that thread t, reading row t as float2,
    starts at 8-byte word (nx / 2) t mod 16 (612 at nx = 14)."""
    nn = nx * nx
    return 3 * nn + (32 - 2 * nn % 32) % 32


_KNOT_STRIDE = slab_knot_stride(14)


class SlabPlan(NamedTuple):
    cluster: int          # CTAs of a shard's cluster (a power of two <= 16)
    knots_per_cta: int    # kc = ceil(L / cluster)
    threads: int          # of one CTA: one per own row, in whole warps
    smem_bytes: int       # dynamic shared memory of one CTA


def slab_smem_bytes(kc: int, nx: int = 14) -> int:
    """One CTA's dynamic shared memory at kc knots (``slab_smem_bytes`` of
    csrc/pcg_slab.cu): four mbarriers, the own knots' Pinv and S blocks,
    the r and u rows with their halo rows, the warp and CTA sums."""
    return 32 + 4 * (2 * slab_knot_stride(nx) * kc + (2 * kc + 6) * nx + 3 * 32
                     + 3 * SLAB_MAX_CLUSTER)


def slab_cluster_plan(L: int, cluster: int | None = None,
                      nx: int = 14) -> SlabPlan:
    """K10a's launch for slabs of L knots: the smallest power of two C with
    ceil(L / C) <= SLAB_TARGET_KNOTS, at most 16 (or ``cluster``, a choice
    the sweep makes by hand).  A fixed function of L (nx sets the threads
    and the shared memory); raises on a shape it cannot launch."""
    if not 2 <= L <= _kernels.MAX_KNOTS:
        raise ValueError(f"slab of {L} knots; K10a takes 2 <= L <= "
                         f"{_kernels.MAX_KNOTS}")
    if cluster is None:
        cluster = 1
        while -(-L // cluster) > SLAB_TARGET_KNOTS and cluster < SLAB_MAX_CLUSTER:
            cluster *= 2
    elif cluster & (cluster - 1) or not 1 <= cluster <= SLAB_MAX_CLUSTER:
        raise ValueError(f"cluster of {cluster} CTAs: a power of two <= "
                         f"{SLAB_MAX_CLUSTER}")
    kc = -(-L // cluster)
    threads = -(-nx * kc // 32) * 32
    if threads > SLAB_MAX_THREADS:
        raise ValueError(f"{kc} knots a CTA: more rows than {SLAB_MAX_THREADS} "
                         "threads")
    smem = slab_smem_bytes(kc, nx)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K10a at L = {L}: {smem} bytes of shared memory a "
                         f"CTA, over {SMEM_LIMIT}")
    return SlabPlan(cluster, kc, threads, smem)


def pcg_slab_step_cuda(st: dict, S, Pinv, flp, frp, PinvL, PinvR, tot,
                       max_iter: int, exit_tol, exit_criterion: str = "eta",
                       init: bool = False) -> None:
    """One step of every shard, in place on the state ``st``; arguments as
    ``pcg_slab_step``.  On the card S and Pinv may be slabs of a larger
    tensor (K9a's halo-extended output): each shard's rows contiguous, the
    shards S.stride(0) floats apart; tot may be a broadcast view."""
    if exit_criterion not in ("eta", "rnorm"):
        raise ValueError(f"unknown exit_criterion {exit_criterion!r}")
    if _kernels.on_cpu(st["x"]):
        pcg_slab_step(st, S, Pinv, flp, frp, PinvL, PinvR, tot, max_iter,
                      exit_tol, exit_criterion, init)
        return
    import torch

    dev = st["x"].device
    n_shard, L, n = st["x"].shape
    require_nx(n)
    plan = slab_cluster_plan(L, nx=n)
    for name in ("x", "r", "p", "s", "u", "w"):
        _kernels.require(st[name], name, (n_shard, L, n), dev)
    _kernels.require(st["pkt"], "pkt", (n_shard, 2, 6, n), dev)
    _kernels.require(st["dots"], "dots", (n_shard, 3), dev)
    _kernels.require(st["scal"], "scal", (n_shard, 2), dev)
    if st["iters"].dtype != torch.int32 or tuple(st["iters"].shape) != (n_shard,) \
            or st["iters"].device != dev:
        raise ValueError("iters: int32 (n_shard,) on the card")
    for name, t in (("S", S), ("Pinv", Pinv)):
        _kernels.require(t, name, (n_shard, L, 3, n, n), dev, slabs=True)
    for name, t in (("flp", flp), ("frp", frp)):
        _kernels.require(t, name, (n_shard, 6, n), dev)
    for name, t in (("PinvL", PinvL), ("PinvR", PinvR)):
        _kernels.require(t, name, (n_shard, 3, n, n), dev)
    if tuple(tot.shape) != (n_shard, 3) or tot.stride(1) != 1 \
            or tot.dtype != torch.float32 or tot.device != dev:
        raise ValueError("tot: f32 (n_shard, 3) on the card, rows of unit stride")
    if S.stride(0) != Pinv.stride(0):
        raise ValueError("S and Pinv: the same stride between shards")
    # the blocks arrive by bulk copies of 16-byte aligned knots, the
    # neighbours' Pinv rows by 8-byte loads
    for name, t, a in (("S", S, 16), ("Pinv", Pinv, 16), ("PinvL", PinvL, 8),
                       ("PinvR", PinvR, 8)):
        if t.data_ptr() % a or t.stride(0) % (a // 4):
            raise ValueError(f"{name}: K10a needs {a}-byte aligned shard slabs")
    tol_t = _kernels.scalar(exit_tol, dev)
    _kernels.launch(
        dev, "pcg_slab.cu", "pcg_slab_launch", n // 2,
        *(st[k].data_ptr() for k in ("x", "r", "p", "s", "u", "w")),
        S.data_ptr(), Pinv.data_ptr(), S.stride(0), flp.data_ptr(),
        frp.data_ptr(), PinvL.data_ptr(), PinvR.data_ptr(), tot.data_ptr(),
        tot.stride(0), st["scal"].data_ptr(), st["iters"].data_ptr(),
        st["dots"].data_ptr(), st["pkt"].data_ptr(), L, n_shard, plan.cluster,
        plan.knots_per_cta, plan.threads, plan.smem_bytes, int(max_iter),
        tol_t.data_ptr(), int(exit_criterion == "rnorm"), int(init))
    pcg_slab_step_cuda.launches += 1


pcg_slab_step_cuda.launches = 0
