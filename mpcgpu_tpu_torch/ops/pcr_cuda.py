"""K7: exact BTD solve by parallel cyclic reduction, with refinement.

Port of ``mpcgpu_tpu/ops/pcr_pallas.py::pcr_solve_pallas_lanes`` (and its
standard-layout entry ``pcr_solve_pallas``); the CUDA kernel is
``csrc/pcr.cu``.  ``pcr_solve_cuda`` runs its plain version
``ops/pcr.py::pcr_solve_refined`` for CPU tensors and the kernel for CUDA
tensors: one launch per solve, factorisation and refinement together, laid
out by ``pcr_plan(N, n)``, from the library built for nq = n / 2.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.ops.pcr import pcr_levels, pcr_solve_refined

# K7's plan (csrc/pcr.cu): knots (one warp each) per CTA, the largest
# cluster (16 is above the portable 8)
PCR_KPC = 4
PCR_MAX_CLUSTER = 16


def pcr_slot_floats(n: int = 14) -> int:
    """SLOT of csrc/pcr.cu: a knot's slot (A, B, v of its last level)."""
    return 2 * n * n + n


def pcr_warp_floats(n: int = 14) -> int:
    """WARP_FLOATS of csrc/pcr.cu: th, b, L and U of two levels, th^{-1},
    the neighbours' slots (two), the residual and three x rows."""
    return 6 * n * n + 5 * n + 2 * pcr_slot_floats(n)


# the IIWA's (n = 14)
_SLOT = pcr_slot_floats(14)
_WARP_FLOATS = pcr_warp_floats(14)


class PcrPlan(NamedTuple):
    ctas: int             # ceil(N / PCR_KPC), one warp per knot
    cluster: bool         # one cluster of all CTAs, else a cooperative launch
    smem_bytes: int       # dynamic shared memory of one CTA


def pcr_smem_bytes(cluster: bool, n: int = 14) -> int:
    """One CTA's dynamic shared memory (``pcr_smem_bytes`` of csrc/pcr.cu)
    for blocks of n x n: each warp's floats, and the CTA's slots where they
    are shared."""
    return 4 * PCR_KPC * (pcr_warp_floats(n) + int(cluster) * 2 * pcr_slot_floats(n))


def pcr_plan(N: int, n: int = 14) -> PcrPlan:
    """The launch of K7 for N knots, a fixed function of N: PCR_KPC knots
    per CTA; one cluster with a cluster barrier between levels where the
    CTAs fit in one (N <= 64), else a cooperative launch with a grid
    barrier.  n, the block size, sets the shared memory."""
    _kernels.require_knots(N)
    ctas = -(-N // PCR_KPC)
    cluster = ctas <= PCR_MAX_CLUSTER
    return PcrPlan(ctas, cluster, pcr_smem_bytes(cluster, n))


def pcr_workspace_floats(N: int, levels: int, n: int = 14) -> int:
    """Floats of the kernel's global workspace: per level th^{-1}, L and U
    (th^{-1} one level more), and two slots (A, B, v) per knot for the
    cooperative launch."""
    return N * ((3 * levels + 1) * n * n + 2 * (2 * n * n + n))


@functools.cache
def resident_ctas(device_index: int, smem_bytes: int, nq: int = 7) -> int:
    """How many CTAs of K7's cooperative launch (built for nq) the card
    holds at once: cudaOccupancyMaxActiveBlocksPerMultiprocessor x its SMs,
    asked of that card."""
    out = torch.zeros((), dtype=torch.int32)
    with torch.cuda.device(device_index):
        code = _kernels.entry("pcr.cu", "pcr_coop_occupancy", nq=nq)(
            smem_bytes, out.data_ptr())
    _kernels.check(code, "pcr_coop_occupancy")
    return int(out) * torch.cuda.get_device_properties(device_index).multi_processor_count


def pcr_solve_cuda(S, b, refine: int = 1):
    """Solve the SPD BTD system S x = b: S (N, 3, n, n) in the layout of
    ``ops/schur.py``, b (N, n); ``refine`` passes of iterative refinement.
    Returns x (N, n).  The kernel takes f32, n = 2 nq (nq 2..7) and 2 <= N
    <= 512."""
    if refine < 0:
        raise ValueError(f"refine must be >= 0, got {refine}")
    if _kernels.on_cpu(b):
        return pcr_solve_refined(S, b, refine=refine)
    dev = b.device
    N, n = b.shape
    if n % 2:
        raise ValueError(f"n = {n}: K7 takes the Schur blocks of nx = 2 nq")
    nq = n // 2
    _kernels.require_nq(nq)
    plan = pcr_plan(N, n)
    _kernels.require(S, "S", (N, 3, n, n), dev)
    _kernels.require(b, "b", (N, n), dev)
    if not plan.cluster:
        held = resident_ctas(dev.index, plan.smem_bytes, nq)
        if held < plan.ctas:
            raise ValueError(f"K7's cooperative launch needs {plan.ctas} "
                             f"resident CTAs; the card holds {held}")
    levels = pcr_levels(N)
    ws = torch.empty((pcr_workspace_floats(N, levels, n),), dtype=torch.float32,
                     device=dev)
    x = torch.empty((N, n), dtype=torch.float32, device=dev)
    _kernels.launch(
        dev, "pcr.cu", "pcr_launch", nq,
        S.data_ptr(), b.data_ptr(), N, levels, int(refine), plan.ctas,
        int(plan.cluster), plan.smem_bytes, ws.data_ptr(), x.data_ptr())
    pcr_solve_cuda.launches += 1
    return x


pcr_solve_cuda.launches = 0
