"""K3: all line-search merits (alpha = -1/2^i, and 0) in one call; K9c:
their per-knot terms on the knot shards' slabs.

Ports of ``mpcgpu_tpu/solver/merit_pallas.py::line_search_merits_pallas``
and ``line_search_merit_partials_slab``; the CUDA kernel is
``csrc/merit.cu``.  ``line_search_merits_fused`` and
``line_search_merit_partials_slab`` run their plain versions for CPU tensors
and the kernel for CUDA tensors.

The kernel gives each (candidate, knot) sample a team of G lanes, P samples
a block, as ``merit_team_plan`` says for the launch's sample count (one
rule for K3, K3b in ``parallel/batched_cuda.py`` and K9c); the merits do not
depend on G or P, since each term is summed as one thread would sum it.
Each launch takes the library built for the model's nq (2..7).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.solver.merit import line_search_merits, merit_partials



def merit_sample_stride(nq: int = 7) -> int:
    """SAMPLE_STRIDE of csrc/merit.cu: one sample's state in shared memory
    (76 nq + 158 floats), made odd."""
    return (76 * nq + 158) | 1


def merit_vec_stride(nq: int = 7) -> int:
    """VEC_STRIDE: one thread's per-link vectors at G = 1 (aba's 20 nq
    floats), made odd."""
    return (20 * nq) | 1


# csrc/merit.cu's shared memory at nq = 7, in floats: the packed model, one
# sample's state (odd stride; G = 1: one thread's per-link vectors);
# block_sum takes 33 more
_MODEL_FLOATS = _kernels.model_floats(7)
_SAMPLE_STRIDE = merit_sample_stride(7)
_VEC_STRIDE = merit_vec_stride(7)
MERIT_TEAMS = (1, 2, 4, 8, 16, 32)
# the most threads of a block: teams, and G <= 2 (G = 1: its registers hold
# the 6x6 matrices; 128 G threads)
MERIT_MAX_THREADS = 512
MERIT_MAX_THREADS_G1 = 128
MERIT_SMEM_LIMIT = 232_448      # one block's shared memory on an H100
# (team lanes G, samples per block P) up to MERIT_SMALL_SAMPLES samples
# (candidates x knots x instances) and above: teams of 16 where a launch is
# latency-bound, a thread per sample where it is issue-bound (the fastest at
# N = 64 for one instance and for 256, tools/torch_port_kernel_ab.py
# --team-sweep)
MERIT_SMALL_SAMPLES = 4096
MERIT_SMALL = (16, 32)
MERIT_LARGE = (1, 64)


# per device: the scratch of the launches whose knots span more than one
# block (each block's per-knot terms, and one counter per candidate and
# instance that the kernel leaves zero), grown as needed
_SPAN_SCRATCH = {}


def merit_span_scratch(dev, N: int, samples: int, rows: int):
    """(terms, done) pointers for a launch of ``rows`` candidates x
    instances at N knots, P = samples per block: 0, 0 when one block holds
    the knots."""
    if N <= samples:
        return 0, 0
    terms, done = _SPAN_SCRATCH.get(dev, (None, None))
    if terms is None or terms.numel() < 2 * N * rows:
        terms = torch.empty((2 * N * rows,), dtype=torch.float32, device=dev)
    if done is None or done.numel() < rows:
        done = torch.zeros((rows,), dtype=torch.int32, device=dev)
    _SPAN_SCRATCH[dev] = (terms, done)
    return terms.data_ptr(), done.data_ptr()


class MeritPlan(NamedTuple):
    team: int         # G: lanes per (candidate, knot) sample
    samples: int      # P: samples in flight per block (P G threads)
    smem_bytes: int   # dynamic shared memory of one block


def merit_max_threads(team: int) -> int:
    return MERIT_MAX_THREADS_G1 * team if team <= 2 else MERIT_MAX_THREADS


def merit_smem_bytes(team: int, samples: int, N: int, nq: int = 7) -> int:
    """Dynamic shared memory of one block of csrc/merit.cu
    (``merit_smem_floats``): the model, the samples' state (G = 1: their
    per-link vectors), each knot's cost and defect, block_sum's 33 floats."""
    stride = merit_vec_stride(nq) if team == 1 else merit_sample_stride(nq)
    return 4 * (_kernels.model_floats(nq) + samples * stride + 2 * N + 33)


def merit_team_plan(N: int, num_samples: int, nq: int = 7) -> MeritPlan:
    """The teams and rounds of a merit launch of num_samples samples
    (candidates x knots x instances or shards) at N knots: MERIT_SMALL up to
    MERIT_SMALL_SAMPLES, MERIT_LARGE above, P cut to at most ceil(N / 32) 32,
    merit_max_threads(G) / G and what fits the shared memory (in multiples
    of 32) at nq joints."""
    team, samples = MERIT_SMALL if num_samples <= MERIT_SMALL_SAMPLES else MERIT_LARGE
    if team not in MERIT_TEAMS:
        raise ValueError(f"team of {team} lanes; the kernel takes {MERIT_TEAMS}")
    stride = merit_vec_stride(nq) if team == 1 else merit_sample_stride(nq)
    fit = (MERIT_SMEM_LIMIT // 4 - _kernels.model_floats(nq) - 2 * N - 33) // stride
    samples = min(samples, merit_max_threads(team) // team, -(-N // 32) * 32,
                  fit // 32 * 32)
    return MeritPlan(team, samples, merit_smem_bytes(team, samples, N, nq))


def line_search_merits_plain(model: RobotModel, cost: CostConfig, xu, dz, xs,
                             ee_goal, mu: float, dt: float, num_alphas: int = 8,
                             integrator_type: int = 0, include_zero: bool = True,
                             angle_wrap: bool = False):
    """``line_search_merits``, with the zero candidate by default."""
    return line_search_merits(model, cost, xu, dz, xs, ee_goal, mu, dt,
                              num_alphas=num_alphas,
                              integrator_type=integrator_type,
                              include_zero=include_zero, angle_wrap=angle_wrap)


def line_search_merits_fused(model: RobotModel, cost: CostConfig, xu, dz, xs,
                             ee_goal, mu: float, dt: float, num_alphas: int = 8,
                             integrator_type: int = 0, include_zero: bool = True,
                             angle_wrap: bool = False):
    """Merits of xu + alpha dz for alpha in (0, -1, -1/2, ...,
    -1/2^(num_alphas-1)), the 0 only with ``include_zero``.

    Returns (merits (A,), alphas (A,)) with A = num_alphas + include_zero;
    with the zero candidate merits[0] is the merit of xu itself.  ee cost
    mode only.
    """
    if cost.mode != "ee":
        raise ValueError("line_search_merits_fused supports ee cost mode only")
    if integrator_type not in (0, 1):
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")
    if _kernels.on_cpu(xu):
        return line_search_merits_plain(model, cost, xu, dz, xs, ee_goal, mu,
                                        dt, num_alphas, integrator_type,
                                        include_zero, angle_wrap)
    dev = xu.device
    nq = model.nq
    _kernels.require_nq(nq)
    N, w = xu.shape
    _kernels.require_knots(N)
    if not 1 <= num_alphas <= 32:
        raise ValueError(f"num_alphas must be in 1..32, got {num_alphas}")
    _kernels.require(xu, "xu", (N, 3 * nq), dev)
    _kernels.require(dz, "dz", (N, 3 * nq), dev)
    _kernels.require(xs, "xs", (2 * nq,), dev)
    _kernels.require(ee_goal[:, :3], "ee_goal[:, :3]", (N, 3), dev,
                     row_major=True)
    packed = model.packed()
    _kernels.require(packed, "model", (packed.numel(),), dev)

    A = num_alphas + int(include_zero)
    plan = merit_team_plan(N, A * N, nq)
    merits = torch.empty((A,), dtype=torch.float32, device=dev)
    alphas = torch.empty((A,), dtype=torch.float32, device=dev)
    _kernels.launch(
        dev, "merit.cu", "merit_launch", nq,
        xu.data_ptr(), dz.data_ptr(), xs.data_ptr(), ee_goal.data_ptr(),
        ee_goal.stride(0), 0, packed.data_ptr(), float(model.gravity),
        float(cost.qd_cost), float(cost.r_cost), float(mu), float(dt), N, A,
        1, *plan, integrator_type, int(angle_wrap), int(include_zero),
        merits.data_ptr(), alphas.data_ptr(),
        *merit_span_scratch(dev, N, plan.samples, A))
    line_search_merits_fused.launches += 1
    return merits, alphas


line_search_merits_fused.launches = 0


def line_search_merit_partials_slab(model: RobotModel, cost: CostConfig, xu_ext,
                                    dz_ext, ee_ext, dt: float,
                                    num_alphas: int = 8,
                                    integrator_type: int = 0,
                                    include_zero: bool = True,
                                    angle_wrap: bool = False):
    """K9c: each knot's cost and defect terms at every line-search candidate
    on n_shard slabs.  xu_ext, dz_ext (n_shard, Le, nx+nu): a shard's knots
    and its right neighbour's first; ee_ext (n_shard, Le, 6).  Returns
    (cost (n_shard, A, Le), defect (n_shard, A, Le), alphas (A,)), A =
    num_alphas + include_zero, the candidates of
    ``line_search_merits_fused``; the slab's last knot has no control term
    and no defect.  The plain version is ``solver/merit.py::merit_partials``."""
    if cost.mode != "ee":
        raise ValueError("line_search_merit_partials_slab supports ee cost mode only")
    if integrator_type not in (0, 1):
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")
    if _kernels.on_cpu(xu_ext):
        return merit_partials(model, cost, xu_ext, dz_ext, ee_ext, dt,
                              num_alphas, integrator_type, include_zero,
                              angle_wrap)
    dev = xu_ext.device
    n_shard, Le = xu_ext.shape[:2]
    nq = model.nq
    _kernels.require_nq(nq)
    if not 1 <= num_alphas <= 32:
        raise ValueError(f"num_alphas must be in 1..32, got {num_alphas}")
    _kernels.require(xu_ext, "xu_ext", (n_shard, Le, 3 * nq), dev)
    _kernels.require(dz_ext, "dz_ext", (n_shard, Le, 3 * nq), dev)
    _kernels.require(ee_ext, "ee_ext", (n_shard, Le, ee_ext.shape[-1]), dev)
    packed = model.packed()
    _kernels.require(packed, "model", (packed.numel(),), dev)
    A = num_alphas + int(include_zero)
    plan = merit_team_plan(Le, A * Le * n_shard, nq)
    part = torch.empty((n_shard, 2, A, Le), dtype=torch.float32, device=dev)
    alphas = torch.empty((n_shard, A), dtype=torch.float32, device=dev)
    _kernels.launch(
        dev, "merit.cu", "merit_partials_launch", nq,
        xu_ext.data_ptr(), dz_ext.data_ptr(), ee_ext.data_ptr(), ee_ext.stride(1),
        ee_ext.stride(0), packed.data_ptr(), float(model.gravity),
        float(cost.qd_cost), float(cost.r_cost), float(dt), Le, A, n_shard,
        *plan, integrator_type, int(angle_wrap), int(include_zero),
        part.data_ptr(), alphas.data_ptr())
    line_search_merit_partials_slab.launches += 1
    return part[:, 0], part[:, 1], alphas[0]


line_search_merit_partials_slab.launches = 0
