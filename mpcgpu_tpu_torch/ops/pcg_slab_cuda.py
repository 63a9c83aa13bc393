"""K10a: one pipelined CG step on every knot shard's slab, the per-shard
compute of the knot-sharded PCG (``parallel/pcg_sharded.py``,
``method="pipelined_slab"``).

Port of ``mpcgpu_tpu/ops/pcg_pallas.py::pcg_slab_step_pallas``; the CUDA
kernel is ``csrc/pcg_slab.cu`` and the plain version
``ops/pcg_slab.py::pcg_slab_step`` (the state and the step are described
there).  ``pcg_slab_step_cuda`` runs the plain version for CPU tensors and
the kernel, one block per shard, for CUDA tensors.
"""

from __future__ import annotations

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.ops.pcg_slab import pcg_slab_step


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
    if n != 14:
        raise ValueError("the CUDA kernels are built for nx = 14")
    if not 2 <= L <= _kernels.MAX_KNOTS:
        raise ValueError(f"slab of {L} knots; K10a takes 2 <= L <= "
                         f"{_kernels.MAX_KNOTS}")
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
    tol_t = _kernels.scalar(exit_tol, dev)
    threads = max(64, min(1024, (L * n + 31) // 32 * 32))
    code = _kernels.entry("pcg_slab.cu", "pcg_slab_launch")(
        *(st[k].data_ptr() for k in ("x", "r", "p", "s", "u", "w")),
        S.data_ptr(), Pinv.data_ptr(), S.stride(0), flp.data_ptr(),
        frp.data_ptr(), PinvL.data_ptr(), PinvR.data_ptr(), tot.data_ptr(),
        tot.stride(0), st["scal"].data_ptr(), st["iters"].data_ptr(),
        st["dots"].data_ptr(), st["pkt"].data_ptr(), L, n_shard, threads,
        int(max_iter), tol_t.data_ptr(), int(exit_criterion == "rnorm"),
        int(init), _kernels.stream_ptr(dev))
    _kernels.check(code, "pcg_slab_launch")
    pcg_slab_step_cuda.launches += 1


pcg_slab_step_cuda.launches = 0
