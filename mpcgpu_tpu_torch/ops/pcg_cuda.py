"""K2 (warm-started stair PCG with the dz recovery as its epilogue), K2' (the
same PCG without the epilogue), K6 (the dz recovery alone) and K9b (K6 on the
knot shards' slabs).

Ports of ``mpcgpu_tpu/ops/pcg_pallas.py::pcg_dz_solve_pallas_lanes`` (K2),
``pcg_solve_pallas_lanes`` / ``pcg_solve_pallas`` (K2') and
``mpcgpu_tpu/solver/kkt_pallas.py::compute_dz_pallas`` (K6) and
``compute_dz_pallas_slab`` (K9b); the CUDA kernels are in
``csrc/pcg_dz.cu``.  K2 and K6 take the K1 output dict
(``solver/kkt_cuda.py``) in knot-leading layout, K9b K9a's with a leading
shard axis; K2' takes the standard (N, 3, n, n) BTD operands.  Each wrapper
runs its plain version for CPU tensors and its kernel for CUDA tensors.
K2, K2' and K8b (``parallel/batched_cuda.py``) run one thread-block
cluster per solve, laid out by ``k2_cluster_plan(N, nx)``; K6 and K9b a
warp per knot, ``dz_plan(N, nx)``, launched with programmatic dependent
launch.  Each launch takes the library built for the system's nq = nx / 2
(2..7).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.ops.pcg import PCGResult, pcg_solve
from mpcgpu_tpu_torch.ops.schur import SchurSystem, compute_dz
from mpcgpu_tpu_torch.solver.kkt import KKTBlocks


# K2's cluster plan (csrc/pcg_dz.cu): the knots a CTA aims at, the largest
# cluster (16 is above the portable 8), the most knots per CTA (16 x 32 =
# MAX_KNOTS)
K2_TARGET_KNOTS = 8
K2_MAX_CLUSTER = 16
K2_MAX_KP = 32


def knot_stride(nx: int = 14) -> int:
    """KNOT_STRIDE: one knot's S or Pinv blocks (3 nx^2 floats) in a CTA's
    shared memory, padded to the least 32 m + nx floats, so that the next
    knot starts nx banks later (590 at nx = 14)."""
    return (3 * nx * nx - nx + 31) // 32 * 32 + nx


_KNOT_STRIDE = knot_stride(14)


class K2Plan(NamedTuple):
    cluster: int          # CTAs of the cluster (a power of two <= 16)
    knots_per_cta: int    # ceil(N / cluster)
    smem_bytes: int       # dynamic shared memory of one CTA


def k2_threads(kp: int, nx: int = 14) -> int:
    """Threads of one CTA: one per own row (nx kp), in whole warps."""
    return max(32, -(-nx * kp // 32) * 32)


def k2_smem_bytes(kp: int, nx: int = 14) -> int:
    """One CTA's dynamic shared memory at kp knots (``k2_smem_floats`` of
    csrc/pcg_dz.cu): two mbarriers, S and Pinv, r and p with a halo row on
    each side, lam, z, Sp, the neighbours' boundary rows of Sp and z, and
    the warp parts of the three sums from every CTA."""
    nw = k2_threads(kp, nx) // 32
    return 4 * (4 + 2 * knot_stride(nx) * kp + 2 * nx * (kp + 2) + 3 * nx * kp
                + 4 * nx + 3 * K2_MAX_CLUSTER * nw)


def k2_cluster_plan(N: int, nx: int = 14) -> K2Plan:
    """The cluster K2, K2' and K8b launch for N knots: the smallest power of
    two C >= N / K2_TARGET_KNOTS, at most 16, and ceil(N / C) knots per
    CTA.  A fixed function of N (nx sets only the shared memory), so the
    three kernels split the knots, and so round, alike."""
    _kernels.require_knots(N)
    want = -(-N // K2_TARGET_KNOTS)
    cluster = 1
    while cluster < want and cluster < K2_MAX_CLUSTER:
        cluster *= 2
    kp = -(-N // cluster)
    return K2Plan(cluster, kp, k2_smem_bytes(kp, nx))


def k2_cluster_occupancy(N: int, dz: bool = True, nx: int = 14) -> int:
    """``cudaOccupancyMaxActiveClusters`` for K2 (dz) or K2' at N knots'
    plan: how many such clusters the card holds at once."""
    plan = k2_cluster_plan(N, nx)
    out = torch.zeros((), dtype=torch.int32)
    code = _kernels.entry("pcg_dz.cu", "pcg_cluster_occupancy", nq=nx // 2)(
        plan.cluster, plan.knots_per_cta, plan.smem_bytes, int(dz),
        out.data_ptr())
    _kernels.check(code, "pcg_cluster_occupancy")
    return int(out)


# K6's and K9b's plan (csrc/pcg_dz.cu::dz_warp_kernel): knots (warps) per
# CTA, and the most the kernel takes
DZ_KNOTS_PER_CTA = 4
DZ_MAX_KPC = 8

# the bytes each dz input's base address must be a multiple of: the kernel
# stages Qinv and A in 16-byte copies, B, q, lam and lam_{k+1} in 8-byte
# ones (a knot's block, row or shard slab is a whole number of chunks at
# every even nx, so only the base can break the rule), u, rho and the last
# flags in 4-byte ones
DZ_ALIGN = {"Qinv": 16, "A": 16, "B": 8, "q": 8, "lam": 8, "lam_next": 8}


class DzPlan(NamedTuple):
    knots_per_cta: int    # warps of a CTA, one knot each
    ctas: int             # CTAs per instance or shard: ceil(N / knots_per_cta)
    smem_bytes: int       # dynamic shared memory of one CTA


def dz_knot_floats(nx: int = 14) -> int:
    """DZ_KNOT_FLOATS: one knot's slot of the kernel's shared memory (Qinv,
    A, B, q, lam, lam_{k+1}, the rhs row, u, rho, the last flag), padded to
    16 bytes (556 floats at nx = 14)."""
    nu = nx // 2
    return (2 * nx * nx + nx * nu + 4 * nx + nu + 2 + 3) // 4 * 4


def dz_plan(N: int, nx: int = 14) -> DzPlan:
    """The grid K6 and K9b launch for N knots (per shard): a warp per knot,
    DZ_KNOTS_PER_CTA knots per CTA (fewer when N is smaller)."""
    _kernels.require_knots(N)
    kpc = min(DZ_KNOTS_PER_CTA, N)
    return DzPlan(kpc, -(-N // kpc), 4 * kpc * dz_knot_floats(nx))


def require_dz_alignment(**tensors) -> None:
    """Raise unless each named dz input's base address is a multiple of
    its ``DZ_ALIGN`` bytes."""
    for name, t in tensors.items():
        if t.data_ptr() % DZ_ALIGN[name]:
            raise ValueError(
                f"{name}: base address {t.data_ptr():#x} is not a multiple of "
                f"{DZ_ALIGN[name]} bytes, which the dz kernel's staging copies need")


def compute_dz_plain(sys: dict, lam, u, rho, r_cost: float):
    """``compute_dz`` on the K1 blocks, with the ee cost's control terms
    R = r_cost I and r = r_cost u."""
    N, nu = u.shape
    rinv = torch.eye(nu, dtype=u.dtype, device=u.device) / (r_cost + rho)
    # compute_dz reads q, r, A, B of the KKT blocks and Qinv, Rinv of the
    # Schur system; A and B drop the kernel's zero last-knot blocks
    kkt = KKTBlocks(Q=None, q=sys["q"], R=None, r=r_cost * u[:-1],
                    A=sys["A"][:-1], B=sys["B"][:-1], c=None)
    schur = SchurSystem(S=None, Pinv=None, gamma=None, Qinv=sys["Qinv"],
                        Rinv=rinv.expand(N - 1, nu, nu))
    return compute_dz(kkt, schur, lam)


def pcg_dz_solve_plain(sys: dict, lam0, u, rho, r_cost: float,
                       max_iter: int = 173, exit_tol=1e-6,
                       exit_criterion: str = "eta"):
    """``pcg_solve`` on (S, Pinv, gamma), then ``compute_dz_plain``."""
    res = pcg_solve(sys["S"], sys["Pinv"], sys["gamma"], lam0,
                    max_iter=max_iter, exit_tol=exit_tol,
                    exit_criterion=exit_criterion)
    return (res.lam, compute_dz_plain(sys, res.lam, u, rho, r_cost),
            res.iters, res.converged)


def require_nx(nx: int) -> None:
    """Raise unless nx is the state size 2 nq of a chain the kernels are
    built for."""
    if nx % 2:
        raise ValueError(f"nx = {nx}: the state is (q, qd), nx = 2 nq")
    _kernels.require_nq(nx // 2)


def _require_system(S, Pinv, gamma, lam0, dev):
    """Check K2's and K2''s system (N, 3, nx, nx) blocks."""
    N, nx = lam0.shape
    require_nx(nx)
    _kernels.require_knots(N)
    for name, t, shape in (("S", S, (N, 3, nx, nx)), ("Pinv", Pinv, (N, 3, nx, nx)),
                           ("gamma", gamma, (N, nx)), ("lam0", lam0, (N, nx))):
        _kernels.require(t, name, shape, dev)


def _require_dz_inputs(sys: dict, u, dev):
    """The dz inputs of a system of nx = 2 nu (the caller has checked nu)."""
    N, nu = u.shape
    nx = 2 * nu
    for name, shape in (("Qinv", (N, nx, nx)), ("A", (N, nx, nx)),
                        ("B", (N, nx, nu)), ("q", (N, nx))):
        _kernels.require(sys[name], name, shape, dev)
    _kernels.require(u, "u", (N, nu), dev, row_major=True)


def _check_pcg_args(exit_criterion: str, max_iter: int) -> None:
    if exit_criterion not in ("eta", "rnorm"):
        raise ValueError(f"unknown exit_criterion {exit_criterion!r}")
    if int(max_iter) < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")


def pcg_dz_solve(sys: dict, lam0, u, rho, r_cost: float, max_iter: int = 173,
                 exit_tol=1e-6, exit_criterion: str = "eta"):
    """K2: solve S lam = gamma from lam0 (N, nx), then recover dz.

    u (N, nu) are the current controls (rows of unit stride, e.g.
    ``xu[:, nx:]``); rho and exit_tol may be floats or 0-d tensors.
    Returns (lam (N, nx), dz (N, nx+nu), iters () int32, converged () bool).
    """
    _check_pcg_args(exit_criterion, max_iter)
    if _kernels.on_cpu(lam0):
        return pcg_dz_solve_plain(sys, lam0, u, rho, r_cost, max_iter,
                                  exit_tol, exit_criterion)
    dev = lam0.device
    N, nx = lam0.shape
    nu = u.shape[-1]
    _require_system(sys["S"], sys["Pinv"], sys["gamma"], lam0, dev)
    if 2 * nu != nx:
        raise ValueError(f"u: {nu} controls for a state of {nx}; nu = nx / 2")
    _require_dz_inputs(sys, u, dev)
    rho_t = _kernels.scalar(rho, dev)
    tol_t = _kernels.scalar(exit_tol, dev)

    plan = k2_cluster_plan(N, nx)
    lam = torch.empty((N, nx), dtype=torch.float32, device=dev)
    dz = torch.empty((N, nx + nu), dtype=torch.float32, device=dev)
    flags = torch.empty((2,), dtype=torch.int32, device=dev)
    _kernels.launch(
        dev, "pcg_dz.cu", "pcg_dz_launch", nu,
        sys["S"].data_ptr(), sys["Pinv"].data_ptr(), sys["gamma"].data_ptr(),
        lam0.data_ptr(), sys["Qinv"].data_ptr(), sys["A"].data_ptr(),
        sys["B"].data_ptr(), sys["q"].data_ptr(), u.data_ptr(), u.stride(0),
        rho_t.data_ptr(), float(r_cost), int(max_iter), tol_t.data_ptr(),
        int(exit_criterion == "rnorm"), N, *plan, lam.data_ptr(), dz.data_ptr(),
        flags.data_ptr(), flags.data_ptr() + 4)
    pcg_dz_solve.launches += 1
    return lam, dz, flags[0], flags[1].bool()


pcg_dz_solve.launches = 0


def pcg_solve_cuda(S, Pinv, gamma, lam0, max_iter: int = 173, exit_tol=1e-6,
                   exit_criterion: str = "eta") -> PCGResult:
    """K2': K2's PCG without the dz epilogue, on BTD S and a 3-band Pinv
    (N, 3, n, n).  A 5-band Pinv (stair2) raises, as the TPU kernel's
    wrapper does.  The plain version is ``pcg_solve``."""
    res = pcg_solve_cuda_uncast(S, Pinv, gamma, lam0, max_iter, exit_tol,
                                exit_criterion)
    return res._replace(converged=res.converged.bool())


def pcg_solve_cuda_uncast(S, Pinv, gamma, lam0, max_iter: int = 173,
                          exit_tol=1e-6, exit_criterion: str = "eta") -> PCGResult:
    """``pcg_solve_cuda`` with the exit flag as K2' wrote it: on the card a
    0-d int32 (1: converged), so that no cast is enqueued behind the kernel
    and the next launch (K6 on the ``fused_dz=False`` route) follows K2'
    directly; the caller casts where it reads the flag."""
    if Pinv.shape[1] != 3:
        raise ValueError(
            f"pcg_solve_cuda takes a 3-band preconditioner, got {Pinv.shape[1]} "
            "bands; use linsys='pcg' for preconditioner='stair2'")
    _check_pcg_args(exit_criterion, max_iter)
    if _kernels.on_cpu(lam0):
        return pcg_solve(S, Pinv, gamma, lam0, max_iter, exit_tol,
                         exit_criterion)
    dev = lam0.device
    N, nx = lam0.shape
    _require_system(S, Pinv, gamma, lam0, dev)
    tol_t = _kernels.scalar(exit_tol, dev)
    plan = k2_cluster_plan(N, nx)
    lam = torch.empty((N, nx), dtype=torch.float32, device=dev)
    flags = torch.empty((2,), dtype=torch.int32, device=dev)
    _kernels.launch(
        dev, "pcg_dz.cu", "pcg_launch", nx // 2,
        S.data_ptr(), Pinv.data_ptr(), gamma.data_ptr(), lam0.data_ptr(),
        int(max_iter), tol_t.data_ptr(), int(exit_criterion == "rnorm"), N,
        *plan, 1, lam.data_ptr(), flags.data_ptr(), flags.data_ptr() + 4)
    pcg_solve_cuda.launches += 1
    return PCGResult(lam=lam, iters=flags[0], converged=flags[1])


pcg_solve_cuda.launches = 0


def compute_dz_cuda(sys: dict, lam, u, rho, r_cost: float):
    """K6: dz (N, nx+nu) from lam (N, nx) and K1's blocks (Qinv, A, B, q):
    dx = Qinv (q - lam + A^T lam_+), du = (r_cost u + B^T lam_+) / (r_cost +
    rho), lam_+ = 0 and du = 0 at the last knot.  rho may be a float or a
    0-d tensor.  The plain version is ``compute_dz_plain``."""
    if _kernels.on_cpu(lam):
        return compute_dz_plain(sys, lam, u, rho, r_cost)
    dev = lam.device
    N, nx = lam.shape
    if nx != 2 * u.shape[-1]:
        raise ValueError(f"u: {u.shape[-1]} controls for a state of {nx}; nu = nx / 2")
    require_nx(nx)
    _kernels.require_knots(N)
    _kernels.require(lam, "lam", (N, nx), dev)
    _require_dz_inputs(sys, u, dev)
    require_dz_alignment(lam=lam, **{k: sys[k] for k in ("Qinv", "A", "B", "q")})
    rho_t = _kernels.scalar(rho, dev)
    dz = torch.empty((N, nx + u.shape[-1]), dtype=torch.float32, device=dev)
    _kernels.launch(
        dev, "pcg_dz.cu", "dz_warp_launch", nx // 2,
        lam.data_ptr(), None, None, sys["Qinv"].data_ptr(), sys["A"].data_ptr(),
        sys["B"].data_ptr(), sys["q"].data_ptr(), N, u.data_ptr(), u.stride(0),
        0, rho_t.data_ptr(), float(r_cost), N, 1, *dz_plan(N, nx), 1,
        dz.data_ptr())
    compute_dz_cuda.launches += 1
    return dz


compute_dz_cuda.launches = 0


def compute_dz_slab_plain(sys: dict, lam, lam_next, last_mask, u, rho,
                          r_cost: float):
    """K9b's plain version: per knot, with lam_+ the row of lam_next and
    nothing of it at a knot whose last flag is set,
    dx = Qinv (q - lam + A^T lam_+), du = (r_cost u + B^T lam_+) / (r_cost +
    rho) (0 at the last knot)."""
    has_next = (last_mask == 0)[..., None]
    at = torch.einsum("...ji,...j->...i", sys["A"], lam_next)
    rhs = torch.where(has_next, (sys["q"] - lam) + at, sys["q"] - lam)
    dx = torch.einsum("...ij,...j->...i", sys["Qinv"], rhs)
    bt = torch.einsum("...ji,...j->...i", sys["B"], lam_next)
    du = (r_cost * u + bt) / (r_cost + rho)
    return torch.cat([dx, torch.where(has_next, du, torch.zeros_like(du))], -1)


def compute_dz_slab(sys: dict, lam, lam_next, last_mask, u, rho, r_cost: float):
    """K9b: dz (n_shard, L, nx+nu) of every knot shard's slab.

    sys holds Qinv, A, B, q (n_shard, L, ...), which on the card may be the
    interior of K9a's halo-extended output (each shard's rows contiguous);
    lam (n_shard, L, nx) the shard's costate rows; lam_next the same rows
    shifted one knot on, with the right neighbour's first row last;
    last_mask (n_shard, L) nonzero at the global last knot; u (n_shard, L,
    nu) the controls (rows of unit stride, e.g. ``xu[..., nx:]``).  rho may be
    a float or a 0-d tensor."""
    if _kernels.on_cpu(lam):
        return compute_dz_slab_plain(sys, lam, lam_next, last_mask, u, rho,
                                     r_cost)
    dev = lam.device
    n_shard, L, nx = lam.shape
    nu = u.shape[-1]
    if nx != 2 * nu:
        raise ValueError(f"u: {nu} controls for a state of {nx}; nu = nx / 2")
    require_nx(nx)
    for name, t in (("lam", lam), ("lam_next", lam_next)):
        _kernels.require(t, name, (n_shard, L, nx), dev)
    _kernels.require(last_mask, "last_mask", (n_shard, L), dev)
    blocks = (("Qinv", (nx, nx)), ("A", (nx, nx)), ("B", (nx, nu)), ("q", (nx,)))
    knot_stride = None
    for name, shape in blocks:
        t = sys[name]
        _kernels.require(t, name, (n_shard, L) + shape, dev, slabs=True)
        per_knot = t[0, 0].numel()
        if t.stride(0) % per_knot or knot_stride not in (None, t.stride(0) // per_knot):
            raise ValueError("Qinv, A, B, q: the same knot stride between shards")
        knot_stride = t.stride(0) // per_knot
    if tuple(u.shape) != (n_shard, L, nu) or u.stride(2) != 1 \
            or u.dtype != torch.float32 or u.device != dev:
        raise ValueError("u: f32 (n_shard, L, nu) on the card with rows of unit stride")
    require_dz_alignment(lam=lam, lam_next=lam_next,
                         **{k: sys[k] for k in ("Qinv", "A", "B", "q")})
    rho_t = _kernels.scalar(rho, dev)
    dz = torch.empty((n_shard, L, nx + nu), dtype=torch.float32, device=dev)
    _kernels.launch(
        dev, "pcg_dz.cu", "dz_warp_launch", nu,
        lam.data_ptr(), lam_next.data_ptr(), last_mask.data_ptr(),
        sys["Qinv"].data_ptr(), sys["A"].data_ptr(), sys["B"].data_ptr(),
        sys["q"].data_ptr(), knot_stride, u.data_ptr(), u.stride(1), u.stride(0),
        rho_t.data_ptr(), float(r_cost), L, n_shard, *dz_plan(L, nx), 1,
        dz.data_ptr())
    compute_dz_slab.launches += 1
    return dz


compute_dz_slab.launches = 0
