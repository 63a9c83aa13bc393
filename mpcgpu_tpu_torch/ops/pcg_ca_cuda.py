"""K10b and the coefficient step: one outer step of the s-step CG on every
knot shard's slab, the per-shard compute of the knot-sharded PCG
(``parallel/pcg_sharded.py``, ``method="ca_slab"``).

K10b is the port of ``mpcgpu_tpu/ops/pcg_pallas.py::pcg_ca_basis_pallas``;
the coefficient step is the port of the XLA ops around it (the coefficient
iterations, the recovery and the next basis scale).  The CUDA kernels are
``csrc/pcg_ca.cu`` and the plain versions ``ops/pcg_ca.py::ca_basis`` and
``ca_coeff_step`` (the state and the steps are described there).  Each
wrapper runs its plain version for CPU tensors and its kernel for CUDA
tensors: K10b one thread-block cluster per shard, laid out by
``ca_cluster_plan(L, s, nx=nx)``; the coefficient step one cluster per shard
too, its rows spread over the CTAs by ``coeff_plan(L, s, nx=nx)``; both from
the library built for nq = nx / 2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.ops.pcg_ca import WORK, ca_basis, ca_coeff_step, n_parts
from mpcgpu_tpu_torch.ops.pcg_cuda import knot_stride, require_nx

# csrc/pcg_ca.cu's limits: the largest s, K10b's largest cluster (16 is above
# the portable 8), the most threads of a CTA; the extended knots a CTA aims
# at, and the shared memory a block may use on an H100.  The stride of one
# knot's S (or Pinv) in a CTA's shared memory, f64 entries, is K2's
# (CA_KNOT_STRIDE = pcg_cuda.knot_stride(nx), 590 at nx = 14)
MAX_S = 8
CA_MAX_CLUSTER = 16
CA_MAX_THREADS = 512
_KNOT_STRIDE = knot_stride(14)
CA_TARGET_KNOTS = 4
SMEM_LIMIT = 232448
# the coefficient step's: the largest cluster, the most threads of a CTA
# (warp 0 for the iterations, the rest one row each), the rows a CTA aims at
COEF_MAX_CLUSTER = 16
COEF_MAX_THREADS = 256
COEF_TARGET_ROWS = 112


class CAPlan(NamedTuple):
    cluster: int          # CTAs of a shard's cluster (a power of two <= 16)
    knots_per_cta: int    # ke = ceil((L + 2h) / cluster) extended knots
    blocks_in_smem: bool  # the own knots' S and Pinv in shared memory
    threads: int          # of one CTA: two (or one) per own row, or per part
    smem_bytes: int       # dynamic shared memory of one CTA


def ca_smem_bytes(ke: int, s: int, blocks: bool, nx: int = 14) -> int:
    """One CTA's dynamic shared memory at ke knots (``ca_smem_bytes`` of
    csrc/pcg_ca.cu): two mbarriers, the four f64 vectors with a halo row on
    each side, Z = [Y | Ytil | r] on the own rows, the Gram partials, and
    (blocks) the own knots' S and Pinv, widened to f64."""
    m = 2 * s + 1
    return (16 + 8 * (4 * (ke + 2) * nx + ke * nx * (2 * m + 1) + n_parts(s))
            + int(blocks) * 8 * 2 * knot_stride(nx) * ke)


def ca_cluster_plan(L: int, s: int, cluster: int | None = None,
                    nx: int = 14) -> CAPlan:
    """K10b's launch for slabs of L knots at s: the smallest power of two C
    with ceil((L + 2h) / C) <= CA_TARGET_KNOTS, at most 16 (or ``cluster``,
    a choice the sweeps make by hand); S and Pinv in shared memory where the
    CTA's whole share fits.  A fixed function of (L, s) (nx sets the
    threads and the shared memory); raises on a shape it cannot launch."""
    h = 2 * s + 1
    if not 1 <= s <= MAX_S:
        raise ValueError(f"s_steps = {s}; the kernels take 1 <= s <= {MAX_S}")
    if not h <= L <= _kernels.MAX_KNOTS:
        raise ValueError(f"slab of {L} knots; the s-step kernels take "
                         f"{h} <= L <= {_kernels.MAX_KNOTS} at s = {s}")
    Le = L + 2 * h
    if cluster is None:
        cluster = 1
        while -(-Le // cluster) > CA_TARGET_KNOTS and cluster < CA_MAX_CLUSTER:
            cluster *= 2
    elif cluster & (cluster - 1) or not 1 <= cluster <= CA_MAX_CLUSTER:
        raise ValueError(f"cluster of {cluster} CTAs: a power of two <= "
                         f"{CA_MAX_CLUSTER}")
    ke = -(-Le // cluster)
    if nx * ke > CA_MAX_THREADS:
        raise ValueError(f"{ke} knots a CTA: more rows than {CA_MAX_THREADS} "
                         "threads")
    blocks = ca_smem_bytes(ke, s, True, nx) <= SMEM_LIMIT
    smem = ca_smem_bytes(ke, s, blocks, nx)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K10b at L = {L}, s = {s}: {smem} bytes of shared "
                         f"memory a CTA, over {SMEM_LIMIT}")
    # two threads a row (V's chain and W's) where they fit, else one
    up32 = lambda v: -(-v // 32) * 32
    rows = up32(2 * nx * ke) if 2 * nx * ke <= CA_MAX_THREADS else up32(nx * ke)
    threads = min(CA_MAX_THREADS, max(rows, up32(n_parts(s))))
    return CAPlan(cluster, ke, blocks, threads, smem)


class CoeffPlan(NamedTuple):
    cluster: int          # CTAs of a shard's cluster (a power of two <= 16)
    rows_per_cta: int     # R = ceil(nx L / cluster) rows of the shard a CTA
    threads: int          # warp 0 and a thread per row, at most 256


def coeff_plan(L: int, s: int, cluster: int | None = None,
               nx: int = 14) -> CoeffPlan:
    """The coefficient step's launch for slabs of L knots at s: the smallest
    power of two C with ceil(nx L / C) <= COEF_TARGET_ROWS, at most 16 (or
    ``cluster``, a choice the sweep makes by hand); every CTA runs the s
    iterations itself and recovers its R rows.  A fixed function of (L, nx);
    raises on a shape it cannot launch."""
    h = 2 * s + 1
    if not 1 <= s <= MAX_S:
        raise ValueError(f"s_steps = {s}; the kernels take 1 <= s <= {MAX_S}")
    if not h <= L <= _kernels.MAX_KNOTS:
        raise ValueError(f"slab of {L} knots; the s-step kernels take "
                         f"{h} <= L <= {_kernels.MAX_KNOTS} at s = {s}")
    n = nx * L
    if cluster is None:
        cluster = 1
        while -(-n // cluster) > COEF_TARGET_ROWS and cluster < COEF_MAX_CLUSTER:
            cluster *= 2
    elif cluster & (cluster - 1) or not 1 <= cluster <= COEF_MAX_CLUSTER:
        raise ValueError(f"cluster of {cluster} CTAs: a power of two <= "
                         f"{COEF_MAX_CLUSTER}")
    rows = -(-n // cluster)
    threads = 32 + min(COEF_MAX_THREADS - 32, -(-rows // 32) * 32)
    return CoeffPlan(cluster, rows, threads)


def _require_state(st: dict, s: int) -> tuple:
    """Raise unless the state's tensors are what the kernels take; returns
    (device, n_shard, L, nx)."""
    dev = st["x"].device
    n_shard, L, n = st["x"].shape
    h = m = 2 * s + 1
    require_nx(n)
    if not 1 <= s <= MAX_S:
        raise ValueError(f"s_steps = {s}; the kernels take 1 <= s <= {MAX_S}")
    if not h <= L <= _kernels.MAX_KNOTS:
        raise ValueError(f"slab of {L} knots; the s-step kernels take "
                         f"{h} <= L <= {_kernels.MAX_KNOTS} at s = {s}")
    for name in ("x", "r", "z", "p"):
        _kernels.require(st[name], name, (n_shard, L, n), dev)
    for name in ("Y", "Yt"):
        _kernels.require(st[name], name, (n_shard, m, L, n), dev, dtype=WORK)
    _kernels.require(st["pkt"], "pkt", (n_shard, 2, 2, h, n), dev)
    _kernels.require(st["parts"], "parts", (n_shard, n_parts(s)), dev, dtype=WORK)
    _kernels.require(st["scal"], "scal", (n_shard, 2), dev, dtype=WORK)
    for name in ("iters", "done"):
        t = st[name]
        if t.dtype != torch.int32 or tuple(t.shape) != (n_shard,) or t.device != dev:
            raise ValueError(f"{name}: int32 ({n_shard},) on the card")
    return dev, n_shard, L, n


def ca_basis_cuda(st: dict, S, Pinv, SL, SR, PL, PR, fl, fr, max_iter: int,
                  s_steps: int = 4) -> None:
    """K10b, in place on ``st``; arguments as ``ops/pcg_ca.py::ca_basis``,
    whose ``s`` is ``s_steps`` here (the JAX ``pcg_ca_basis_pallas``'s name
    and default).  On the card S and Pinv may be slabs of a larger tensor
    (K9a's halo-extended output): each shard's rows contiguous, the shards
    S.stride(0) floats apart."""
    s = s_steps
    if _kernels.on_cpu(st["x"]):
        ca_basis(st, S, Pinv, SL, SR, PL, PR, fl, fr, max_iter, s)
        return
    dev, n_shard, L, nx = _require_state(st, s)
    plan = ca_cluster_plan(L, s, nx=nx)
    h = 2 * s + 1
    for name, t in (("S", S), ("Pinv", Pinv)):
        _kernels.require(t, name, (n_shard, L, 3, nx, nx), dev, slabs=True)
    if S.stride(0) != Pinv.stride(0):
        raise ValueError("S and Pinv: the same stride between shards")
    for name, t in (("SL", SL), ("SR", SR), ("PL", PL), ("PR", PR)):
        _kernels.require(t, name, (n_shard, h, 3, nx, nx), dev)
    # K10b reads the blocks by 16-byte loads
    for name, t in (("S", S), ("Pinv", Pinv), ("SL", SL), ("SR", SR),
                    ("PL", PL), ("PR", PR)):
        if t.data_ptr() % 16 or t.stride(0) % 4:
            raise ValueError(f"{name}: K10b needs 16-byte aligned shard slabs")
    for name, t in (("fl", fl), ("fr", fr)):
        _kernels.require(t, name, (n_shard, 2, h, nx), dev)
    _kernels.launch(
        dev, "pcg_ca.cu", "ca_basis_launch", nx // 2,
        st["p"].data_ptr(), st["z"].data_ptr(), st["r"].data_ptr(),
        S.data_ptr(), Pinv.data_ptr(), S.stride(0), SL.data_ptr(),
        SR.data_ptr(), PL.data_ptr(), PR.data_ptr(), fl.data_ptr(),
        fr.data_ptr(), st["scal"].data_ptr(), st["iters"].data_ptr(),
        st["done"].data_ptr(), st["Y"].data_ptr(), st["Yt"].data_ptr(),
        st["parts"].data_ptr(), L, s, n_shard, int(max_iter), plan.cluster,
        plan.knots_per_cta, int(plan.blocks_in_smem), plan.threads,
        plan.smem_bytes)
    ca_basis_cuda.launches += 1


def ca_coeff_step_cuda(st: dict, tot, max_iter: int, exit_tol,
                       exit_criterion: str, s: int) -> None:
    """The coefficient step, in place on ``st``; arguments as
    ``ops/pcg_ca.py::ca_coeff_step``.  On the card tot may be a broadcast
    view (the mesh's psum): rows of unit stride."""
    if exit_criterion not in ("eta", "rnorm"):
        raise ValueError(f"unknown exit_criterion {exit_criterion!r}")
    if _kernels.on_cpu(st["x"]):
        ca_coeff_step(st, tot, max_iter, exit_tol, exit_criterion, s)
        return
    dev, n_shard, L, nx = _require_state(st, s)
    if tuple(tot.shape) != (n_shard, n_parts(s)) or tot.stride(1) != 1 \
            or tot.dtype != WORK or tot.device != dev:
        raise ValueError(f"tot: f64 ({n_shard}, {n_parts(s)}) on the card, rows "
                         "of unit stride")
    plan = coeff_plan(L, s, nx=nx)
    tol_t = _kernels.scalar(exit_tol, dev)
    _kernels.launch(
        dev, "pcg_ca.cu", "ca_coeff_launch", nx // 2,
        *(st[k].data_ptr() for k in ("x", "r", "z", "p", "Y", "Yt")),
        tot.data_ptr(), tot.stride(0), st["scal"].data_ptr(),
        st["iters"].data_ptr(), st["done"].data_ptr(), st["pkt"].data_ptr(),
        L, s, n_shard, plan.cluster, plan.rows_per_cta, plan.threads,
        int(max_iter), tol_t.data_ptr(), int(exit_criterion == "rnorm"))
    ca_coeff_step_cuda.launches += 1


ca_basis_cuda.launches = 0
ca_coeff_step_cuda.launches = 0
