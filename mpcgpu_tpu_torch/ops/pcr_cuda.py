"""K7: exact BTD solve by parallel cyclic reduction, with refinement.

Port of ``mpcgpu_tpu/ops/pcr_pallas.py::pcr_solve_pallas_lanes`` (and its
standard-layout entry ``pcr_solve_pallas``); the CUDA kernel is
``csrc/pcr.cu``.  ``pcr_solve_cuda`` runs its plain version
``ops/pcr.py::pcr_solve_refined`` for CPU tensors and the kernel for CUDA
tensors.
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.ops.pcr import pcr_levels, pcr_solve_refined


def pcr_workspace_floats(N: int, levels: int, n: int = 14) -> int:
    """Floats of the kernel's workspace: per level th^{-1}, L, U, A, B and v
    (th^{-1} one level more), and each knot's current th and b."""
    return N * ((5 * levels + 2) * n * n + (levels + 1) * n)


def pcr_solve_cuda(S, b, refine: int = 1):
    """Solve the SPD BTD system S x = b: S (N, 3, n, n) in the layout of
    ``ops/schur.py``, b (N, n); ``refine`` passes of iterative refinement.
    Returns x (N, n).  The kernel takes f32, n = 14 and 2 <= N <= 512."""
    if refine < 0:
        raise ValueError(f"refine must be >= 0, got {refine}")
    if _kernels.on_cpu(b):
        return pcr_solve_refined(S, b, refine=refine)
    dev = b.device
    N, n = b.shape
    if n != 14:
        raise ValueError("the CUDA kernels are built for nx = 14")
    _kernels.require_knots(N)
    _kernels.require(S, "S", (N, 3, n, n), dev)
    _kernels.require(b, "b", (N, n), dev)
    levels = pcr_levels(N)
    ws = torch.empty((pcr_workspace_floats(N, levels),), dtype=torch.float32,
                     device=dev)
    x = torch.empty((N, n), dtype=torch.float32, device=dev)
    code = _kernels.entry("pcr.cu", "pcr_launch")(
        S.data_ptr(), b.data_ptr(), N, levels, int(refine), ws.data_ptr(),
        x.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.check(code, "pcr_launch")
    pcr_solve_cuda.launches += 1
    return x


pcr_solve_cuda.launches = 0
