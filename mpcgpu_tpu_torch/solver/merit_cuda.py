"""K3: all line-search merits (alpha = 0 and -1/2^i) in one call; K9c:
their per-knot terms on the knot shards' slabs.

Ports of ``mpcgpu_tpu/solver/merit_pallas.py::line_search_merits_pallas``
and ``line_search_merit_partials_slab``; the CUDA kernel is
``csrc/merit.cu``.  ``line_search_merits_fused`` and
``line_search_merit_partials_slab`` run their plain versions for CPU tensors
and the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.solver.merit import line_search_merits, merit_partials


def line_search_merits_plain(model: RobotModel, cost: CostConfig, xu, dz, xs,
                             ee_goal, mu: float, dt: float, num_alphas: int = 8,
                             integrator_type: int = 0, angle_wrap: bool = False):
    """``line_search_merits(include_zero=True)``."""
    return line_search_merits(model, cost, xu, dz, xs, ee_goal, mu, dt,
                              num_alphas=num_alphas,
                              integrator_type=integrator_type,
                              include_zero=True, angle_wrap=angle_wrap)


def line_search_merits_fused(model: RobotModel, cost: CostConfig, xu, dz, xs,
                             ee_goal, mu: float, dt: float, num_alphas: int = 8,
                             integrator_type: int = 0, angle_wrap: bool = False):
    """Merits of xu + alpha dz for alpha in (0, -1, -1/2, ..., -1/2^(A-2)).

    Returns (merits (A,), alphas (A,)) with A = num_alphas + 1; merits[0] is
    the merit of xu itself.  ee cost mode only.
    """
    if cost.mode != "ee":
        raise ValueError("line_search_merits_fused supports ee cost mode only")
    if integrator_type not in (0, 1):
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")
    if _kernels.on_cpu(xu):
        return line_search_merits_plain(model, cost, xu, dz, xs, ee_goal, mu,
                                        dt, num_alphas, integrator_type,
                                        angle_wrap)
    dev = xu.device
    N, w = xu.shape
    if model.nq != 7 or w != 21:
        raise ValueError("the CUDA kernels are built for nq = 7 (xu rows of 21)")
    _kernels.require_knots(N)
    if not 1 <= num_alphas <= 32:
        raise ValueError(f"num_alphas must be in 1..32, got {num_alphas}")
    _kernels.require(xu, "xu", (N, w), dev)
    _kernels.require(dz, "dz", (N, w), dev)
    _kernels.require(xs, "xs", (14,), dev)
    _kernels.require(ee_goal[:, :3], "ee_goal[:, :3]", (N, 3), dev,
                     row_major=True)
    packed = model.packed()
    _kernels.require(packed, "model", (packed.numel(),), dev)

    A = num_alphas + 1
    threads = min(512, (N + 31) // 32 * 32)
    merits = torch.empty((A,), dtype=torch.float32, device=dev)
    alphas = torch.empty((A,), dtype=torch.float32, device=dev)
    code = _kernels.entry("merit.cu", "merit_launch")(
        xu.data_ptr(), dz.data_ptr(), xs.data_ptr(), ee_goal.data_ptr(),
        ee_goal.stride(0), 0, packed.data_ptr(), float(model.gravity),
        float(cost.qd_cost), float(cost.r_cost), float(mu), float(dt), N, A,
        1, threads, integrator_type, int(angle_wrap), merits.data_ptr(),
        alphas.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.check(code, "merit_launch")
    line_search_merits_fused.launches += 1
    return merits, alphas


line_search_merits_fused.launches = 0


def line_search_merit_partials_slab(model: RobotModel, cost: CostConfig, xu_ext,
                                    dz_ext, ee_ext, dt: float,
                                    num_alphas: int = 8,
                                    integrator_type: int = 0):
    """K9c: each knot's cost and defect terms at every line-search candidate
    on n_shard slabs.  xu_ext, dz_ext (n_shard, Le, nx+nu): a shard's knots
    and its right neighbour's first; ee_ext (n_shard, Le, 6).  Returns
    (cost (n_shard, A, Le), defect (n_shard, A, Le), alphas (A,)), A =
    num_alphas + 1; the slab's last knot has no control term and no defect.
    The plain version is ``solver/merit.py::merit_partials``."""
    if cost.mode != "ee":
        raise ValueError("line_search_merit_partials_slab supports ee cost mode only")
    if integrator_type not in (0, 1):
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")
    if _kernels.on_cpu(xu_ext):
        return merit_partials(model, cost, xu_ext, dz_ext, ee_ext, dt,
                              num_alphas, integrator_type)
    dev = xu_ext.device
    n_shard, Le, w = xu_ext.shape
    if model.nq != 7 or w != 21:
        raise ValueError("the CUDA kernels are built for nq = 7 (xu rows of 21)")
    if not 1 <= num_alphas <= 32:
        raise ValueError(f"num_alphas must be in 1..32, got {num_alphas}")
    _kernels.require(xu_ext, "xu_ext", (n_shard, Le, w), dev)
    _kernels.require(dz_ext, "dz_ext", (n_shard, Le, w), dev)
    _kernels.require(ee_ext, "ee_ext", (n_shard, Le, ee_ext.shape[-1]), dev)
    packed = model.packed()
    _kernels.require(packed, "model", (packed.numel(),), dev)
    A = num_alphas + 1
    threads = min(512, (Le + 31) // 32 * 32)
    part = torch.empty((n_shard, 2, A, Le), dtype=torch.float32, device=dev)
    alphas = torch.empty((n_shard, A), dtype=torch.float32, device=dev)
    code = _kernels.entry("merit.cu", "merit_partials_launch")(
        xu_ext.data_ptr(), dz_ext.data_ptr(), ee_ext.data_ptr(), ee_ext.stride(1),
        ee_ext.stride(0), packed.data_ptr(), float(model.gravity),
        float(cost.qd_cost), float(cost.r_cost), float(dt), Le, A, n_shard,
        threads, integrator_type, part.data_ptr(), alphas.data_ptr(),
        _kernels.stream_ptr(dev))
    _kernels.check(code, "merit_partials_launch")
    line_search_merit_partials_slab.launches += 1
    return part[:, 0], part[:, 1], alphas[0]


line_search_merit_partials_slab.launches = 0
