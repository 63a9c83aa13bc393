"""K8: the batched SQP solve with the instance as a grid axis.

Port of ``mpcgpu_tpu/parallel/batched_fused.py``.  On the TPU that module
packs several instances along the 128 lanes of a vreg
(``instances_per_program``, ``pack_lanes``, ``unpack_lanes``) and runs a
Pallas grid over instance groups, with segmented reductions that give each
packed instance its own CG scalars.  On a GPU the instance is simply one
more grid axis of the single-instance kernels, so the packing has no
counterpart here and every tensor keeps the (B, N, ...) layout:

  * K8a ``build_kkt_schur_batched``: K1's launch over a (window, instance)
    grid with K1's windows and a per-instance rho (replaces
    batched_fused.py:150);
  * K8b ``pcg_solve_batched``: K2' with one cluster per instance, each with
    its own CG scalars and its own exit, so every instance's iterations and
    exit flag are exact (replaces batched_fused.py:335);
  * K8c ``compute_dz_batched``: K6 over (knot, instance) with a
    per-instance rho (replaces batched_fused.py:391);
  * ``line_search_merits_batched``: K3 over (candidate, instance), the
    batched use of the merit kernel that the JAX package reaches by vmap,
    with K3's team rule.

The kernels are the single-instance kernels' bodies with an instance offset
(``csrc/kkt_schur.cu``, ``pcg_dz.cu``, ``merit.cu``), built for the model's
nq (2..7), so each instance's result equals the single-instance launch's bit
for bit.  Each wrapper runs
its plain version (a loop of the single-instance plain versions, stacked)
for CPU tensors and its kernel for CUDA tensors; the plain versions are
``*_batched_plain``.

``sqp_solve_batched_fused`` keeps the JAX loop's semantics: the fixed PCG
exit tolerance (no Eisenstat-Walker forcing), a Levenberg-Marquardt rho
schedule and line search per instance, an instance that gives up frozen
from then on, per-instance ``sqp_iters``, and iterations while any instance
is active and ``it < max_iter``.  ``sqp_solve_batched_fused_sharded`` runs it
on each instance group of an (instance, knot) mesh (``parallel/mesh.py``).
Under a ``torch.profiler`` session it records the spans and counters that
``solver/sqp.py::sqp_solve`` records (``utils/profiling.py``), with the
batch size on each span and frozen instances left out of the counters.
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.ops.pcg import pcg_solve
from mpcgpu_tpu_torch.ops.pcg_cuda import (_check_pcg_args, compute_dz_plain,
                                           k2_cluster_plan, require_nx)
from mpcgpu_tpu_torch.solver.kkt_cuda import (_check_args, build_kkt_schur_plain,
                                              kkt_window_plan)
from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merits_plain,
                                                merit_span_scratch,
                                                merit_team_plan)
from mpcgpu_tpu_torch.solver.sqp import SQPResult, line_search_update
from mpcgpu_tpu_torch.utils import profiling


def _stack(results):
    """A list of per-instance results (dicts or tuples) stacked on axis 0."""
    if isinstance(results[0], dict):
        return {k: torch.stack([r[k] for r in results]) for k in results[0]}
    return tuple(torch.stack(parts) for parts in zip(*results))


def _require_batch(model: RobotModel, xu_b, ee_b):
    """Check the shared kernel inputs; returns (B, N, packed model)."""
    nq = model.nq
    _kernels.require_nq(nq)
    dev = xu_b.device
    B, N = xu_b.shape[:2]
    _kernels.require_knots(N)
    _kernels.require(xu_b, "xu", (B, N, 3 * nq), dev)
    _kernels.require(ee_b, "ee_goal", (B, N, ee_b.shape[-1]), dev)
    packed = model.packed()
    _kernels.require(packed, "model", (packed.numel(),), dev)
    return B, N, packed


def build_kkt_schur_batched_plain(model: RobotModel, cost: CostConfig, xu_b,
                                  xs_b, ee_b, rho_b, dt: float,
                                  integrator_type: int = 0,
                                  angle_wrap: bool = False) -> dict:
    """``build_kkt_schur_plain`` per instance, stacked."""
    return _stack([build_kkt_schur_plain(
        model, cost, xu_b[i], xs_b[i], ee_b[i], rho_b[i], dt, integrator_type,
        angle_wrap) for i in range(xu_b.shape[0])])


def pcg_solve_batched_plain(S, Pinv, gamma, lam0, max_iter: int = 173,
                            exit_tol=1e-6, exit_criterion: str = "eta"):
    """``pcg_solve`` per instance, stacked."""
    return _stack([tuple(pcg_solve(S[i], Pinv[i], gamma[i], lam0[i], max_iter,
                                   exit_tol, exit_criterion))
                   for i in range(lam0.shape[0])])


def compute_dz_batched_plain(sys: dict, lam, u, rho_b, r_cost: float):
    """``compute_dz_plain`` per instance, stacked."""
    return torch.stack([compute_dz_plain({k: v[i] for k, v in sys.items()},
                                         lam[i], u[i], rho_b[i], r_cost)
                        for i in range(lam.shape[0])])


def line_search_merits_batched_plain(model: RobotModel, cost: CostConfig, xu_b,
                                     dz_b, xs_b, ee_b, mu: float, dt: float,
                                     num_alphas: int = 8,
                                     integrator_type: int = 0,
                                     angle_wrap: bool = False):
    """``line_search_merits_plain`` per instance, stacked."""
    return _stack([line_search_merits_plain(
        model, cost, xu_b[i], dz_b[i], xs_b[i], ee_b[i], mu, dt, num_alphas,
        integrator_type, angle_wrap=angle_wrap) for i in range(xu_b.shape[0])])


def build_kkt_schur_batched(model: RobotModel, cost: CostConfig, xu_b, xs_b,
                            ee_b, rho_b, dt: float, integrator_type: int = 0,
                            angle_wrap: bool = False) -> dict:
    """K8a: K1 for B instances.  xu_b (B, N, nx+nu), xs_b (B, nx), ee_b
    (B, N, 6), rho_b (B,) -> S, Pinv (B, N, 3, nx, nx), gamma (B, N, nx),
    Qinv, A (B, N, nx, nx), B (B, N, nx, nu), q (B, N, nx)."""
    _check_args(cost, integrator_type)
    if _kernels.on_cpu(xu_b):
        return build_kkt_schur_batched_plain(model, cost, xu_b, xs_b, ee_b,
                                             rho_b, dt, integrator_type,
                                             angle_wrap)
    dev = xu_b.device
    B, N, packed = _require_batch(model, xu_b, ee_b)
    _kernels.require(rho_b, "rho", (B,), dev)
    nq = model.nq
    nx = 2 * nq
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(S=torch.empty((B, N, 3, nx, nx), **f32),
               Pinv=torch.empty((B, N, 3, nx, nx), **f32),
               gamma=torch.empty((B, N, nx), **f32),
               Qinv=torch.empty((B, N, nx, nx), **f32),
               A=torch.empty((B, N, nx, nx), **f32),
               B=torch.empty((B, N, nx, nq), **f32),
               q=torch.empty((B, N, nx), **f32))
    plan = kkt_window_plan(N, nq=nq)
    _kernels.launch(
        dev, "kkt_schur.cu", "kkt_schur_launch", nq,
        xu_b.data_ptr(), xu_b.stride(1), xu_b.stride(0), ee_b.data_ptr(),
        ee_b.stride(1), ee_b.stride(0), rho_b.data_ptr(), float(dt),
        packed.data_ptr(), float(model.gravity), float(cost.qd_cost),
        float(cost.r_cost), N, B, plan.window, plan.smem_bytes,
        integrator_type, int(angle_wrap), int(cost.terminal_at_last_state),
        out["S"].data_ptr(), out["Pinv"].data_ptr(), out["gamma"].data_ptr(),
        out["Qinv"].data_ptr(), out["A"].data_ptr(), out["B"].data_ptr(),
        out["q"].data_ptr())
    build_kkt_schur_batched.launches += 1
    return out


build_kkt_schur_batched.launches = 0


def pcg_solve_batched(S, Pinv, gamma, lam0, max_iter: int = 173,
                      exit_tol=1e-6, exit_criterion: str = "eta"):
    """K8b: K2' for B instances: S, Pinv (B, N, 3, n, n), gamma and lam0
    (B, N, n).  Returns (lam (B, N, n), iters (B,) int32, converged (B,)
    bool).  exit_tol (one for all instances) may be a float or a 0-d
    tensor."""
    _check_pcg_args(exit_criterion, max_iter)
    if _kernels.on_cpu(lam0):
        return pcg_solve_batched_plain(S, Pinv, gamma, lam0, max_iter, exit_tol,
                                       exit_criterion)
    dev = lam0.device
    B, N, nx = lam0.shape
    require_nx(nx)
    _kernels.require_knots(N)
    for name, t, shape in (("S", S, (B, N, 3, nx, nx)),
                           ("Pinv", Pinv, (B, N, 3, nx, nx)),
                           ("gamma", gamma, (B, N, nx)), ("lam0", lam0, (B, N, nx))):
        _kernels.require(t, name, shape, dev)
    tol_t = _kernels.scalar(exit_tol, dev)
    plan = k2_cluster_plan(N, nx)
    lam = torch.empty((B, N, nx), dtype=torch.float32, device=dev)
    flags = torch.empty((2, B), dtype=torch.int32, device=dev)
    _kernels.launch(
        dev, "pcg_dz.cu", "pcg_launch", nx // 2,
        S.data_ptr(), Pinv.data_ptr(), gamma.data_ptr(), lam0.data_ptr(),
        int(max_iter), tol_t.data_ptr(), int(exit_criterion == "rnorm"), N,
        *plan, B, lam.data_ptr(), flags[0].data_ptr(), flags[1].data_ptr())
    pcg_solve_batched.launches += 1
    return lam, flags[0], flags[1].bool()


pcg_solve_batched.launches = 0


def compute_dz_batched(sys: dict, lam, u, rho_b, r_cost: float):
    """K8c: K6 for B instances: dz (B, N, nx+nu) from lam (B, N, nx), K8a's
    blocks, the controls u (B, N, nu) (rows of unit stride, e.g.
    ``xu_b[:, :, nx:]``) and rho_b (B,)."""
    if _kernels.on_cpu(lam):
        return compute_dz_batched_plain(sys, lam, u, rho_b, r_cost)
    dev = lam.device
    B, N, nx = lam.shape
    nu = u.shape[-1]
    if nx != 2 * nu:
        raise ValueError(f"u: {nu} controls for a state of {nx}; nu = nx / 2")
    require_nx(nx)
    _kernels.require_knots(N)
    _kernels.require(lam, "lam", (B, N, nx), dev)
    for name, shape in (("Qinv", (B, N, nx, nx)), ("A", (B, N, nx, nx)),
                        ("B", (B, N, nx, nu)), ("q", (B, N, nx))):
        _kernels.require(sys[name], name, shape, dev)
    if tuple(u.shape) != (B, N, nu) or u.stride(2) != 1 or u.dtype != torch.float32 \
            or u.device != dev:
        raise ValueError("u: f32 (B, N, nu) on the card with rows of unit stride")
    _kernels.require(rho_b, "rho", (B,), dev)
    dz = torch.empty((B, N, nx + nu), dtype=torch.float32, device=dev)
    _kernels.launch(
        dev, "pcg_dz.cu", "dz_launch", nu,
        lam.data_ptr(), sys["Qinv"].data_ptr(), sys["A"].data_ptr(),
        sys["B"].data_ptr(), sys["q"].data_ptr(), u.data_ptr(), u.stride(1),
        u.stride(0), rho_b.data_ptr(), float(r_cost), N, B, dz.data_ptr())
    compute_dz_batched.launches += 1
    return dz


compute_dz_batched.launches = 0


def line_search_merits_batched(model: RobotModel, cost: CostConfig, xu_b, dz_b,
                               xs_b, ee_b, mu: float, dt: float,
                               num_alphas: int = 8, integrator_type: int = 0,
                               angle_wrap: bool = False):
    """K3 for B instances: merits (B, A) of xu_b + alpha dz_b for alpha in
    (0, -1, -1/2, ..., -1/2^(A-2)), A = num_alphas + 1, and alphas (B, A).
    ee cost mode only."""
    if cost.mode != "ee":
        raise ValueError("line_search_merits_batched supports ee cost mode only")
    if integrator_type not in (0, 1):
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")
    if _kernels.on_cpu(xu_b):
        return line_search_merits_batched_plain(model, cost, xu_b, dz_b, xs_b,
                                                ee_b, mu, dt, num_alphas,
                                                integrator_type, angle_wrap)
    dev = xu_b.device
    B, N, packed = _require_batch(model, xu_b, ee_b)
    if not 1 <= num_alphas <= 32:
        raise ValueError(f"num_alphas must be in 1..32, got {num_alphas}")
    nq = model.nq
    _kernels.require(dz_b, "dz", (B, N, 3 * nq), dev)
    _kernels.require(xs_b, "xs", (B, 2 * nq), dev)
    A = num_alphas + 1
    plan = merit_team_plan(N, A * N * B, nq)
    merits = torch.empty((B, A), dtype=torch.float32, device=dev)
    alphas = torch.empty((B, A), dtype=torch.float32, device=dev)
    # always the zero candidate, as the JAX batched solve fixes include_zero
    _kernels.launch(
        dev, "merit.cu", "merit_launch", nq,
        xu_b.data_ptr(), dz_b.data_ptr(), xs_b.data_ptr(), ee_b.data_ptr(),
        ee_b.stride(1), ee_b.stride(0), packed.data_ptr(), float(model.gravity),
        float(cost.qd_cost), float(cost.r_cost), float(mu), float(dt), N, A, B,
        *plan, integrator_type, int(angle_wrap), 1, merits.data_ptr(),
        alphas.data_ptr(), *merit_span_scratch(dev, N, plan.samples, A * B))
    line_search_merits_batched.launches += 1
    return merits, alphas


line_search_merits_batched.launches = 0


def sqp_solve_batched_fused(
    model: RobotModel,
    cost: CostConfig,
    sqp_cfg: SQPConfig,
    pcg_cfg: PCGConfig,
    xu_b, lam_b, xs_b, ee_b, rho_b, dt: float,
    integrator_type: int = 0,
    angle_wrap: bool = False,
    merit_impl: str = "auto",
) -> SQPResult:
    """B SQP solves through K8a -> K8b -> K8c -> batched K3 per iteration.

    xu_b (B, N, nx+nu), lam_b (B, N, nx), xs_b (B, nx), ee_b (B, N, 6), rho_b
    (B,) tensor.  Every SQPResult field gains a leading instance axis.  The
    loop reads ``all(stop)`` back to the host once per iteration after the
    first.  merit_impl picks the merits, as ``sqp_solve``'s does: "cuda"
    the batched K3 (its plain version on CPU tensors), "plain"
    ``line_search_merits(include_zero=True)`` per instance, "auto" the
    batched K3 on the card in ee cost mode and the plain merits otherwise."""
    if pcg_cfg.preconditioner != "stair":
        raise ValueError("the batched kernels implement the stair "
                         "preconditioner only")
    if merit_impl == "auto":
        use_kernel = xu_b.device.type == "cuda" and cost.mode == "ee"
    elif merit_impl in ("cuda", "plain"):
        use_kernel = merit_impl == "cuda"
    else:
        raise ValueError(f"unknown merit_impl {merit_impl!r}")
    merits_of = (line_search_merits_batched if use_kernel
                 else line_search_merits_batched_plain)
    B = xu_b.shape[0]
    tr = profiling.solve_trace(B)
    nx = 2 * model.nq
    dev, dtype = xu_b.device, xu_b.dtype
    max_iter = sqp_cfg.max_iter
    mu = float(sqp_cfg.mu)
    exit_tol = _kernels.scalar(pcg_cfg.exit_tol, dev, dtype)

    xu, lam = xu_b, lam_b
    rho = rho_b.to(device=dev, dtype=dtype)
    drho = torch.ones((B,), dtype=dtype, device=dev)
    merit = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    stop = torch.zeros((B,), dtype=torch.bool, device=dev)
    gave_up_any = torch.zeros((B,), dtype=torch.bool, device=dev)
    sqp_iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    pcg_iters = torch.full((B, max_iter), -1, dtype=torch.int32, device=dev)
    pcg_converged = torch.zeros((B, max_iter), dtype=torch.bool, device=dev)
    ls_alpha_idx = torch.full((B, max_iter), -1, dtype=torch.int32, device=dev)

    it = 0
    while it < max_iter:
        if it:
            if tr:
                tr.phase("sqp.stop_read", it - 1)
            if bool(stop.all()):
                break
        if tr:
            tr.phase("sqp.kkt", it)
        sys = build_kkt_schur_batched(model, cost, xu, xs_b, ee_b, rho, dt,
                                      integrator_type, angle_wrap)
        if tr:
            tr.phase("sqp.linsys")
        lam_new, lin_iters, lin_ok = pcg_solve_batched(
            sys["S"], sys["Pinv"], sys["gamma"], lam,
            max_iter=pcg_cfg.max_iter, exit_tol=exit_tol,
            exit_criterion=pcg_cfg.exit_criterion)
        if tr:
            tr.phase("sqp.dz")
        dz = compute_dz_batched(sys, lam_new, xu[:, :, nx:], rho, cost.r_cost)
        if tr:
            tr.lam_solved(lam_new)
            tr.phase("sqp.merits")
        merits, alphas = merits_of(
            model, cost, xu, dz, xs_b, ee_b, mu, dt,
            num_alphas=sqp_cfg.num_alphas, integrator_type=integrator_type,
            angle_wrap=angle_wrap)

        if tr:
            tr.phase("sqp.step")
        step = line_search_update(merits, alphas, rho, drho, sqp_cfg)
        # an instance that gave up earlier is frozen: nothing of it changes
        frozen = stop
        take = step.success & ~frozen
        xu = torch.where(take[:, None, None], xu + step.alpha[:, None, None] * dz, xu)
        lam = torch.where(frozen[:, None, None], lam, lam_new)
        rho = torch.where(frozen, rho, step.rho)
        drho = torch.where(frozen, drho, step.drho)
        merit = torch.where(frozen, merit, step.merit)
        stop = frozen | step.stop
        gave_up_any = gave_up_any | step.stop
        sqp_iters = sqp_iters + (~frozen).to(torch.int32)
        for buf, v in ((pcg_iters, lin_iters), (pcg_converged, lin_ok),
                       (ls_alpha_idx, step.alpha_idx)):
            buf[:, it] = torch.where(frozen, buf[:, it], v)
        it += 1

    result = SQPResult(xu=xu, lam=lam, rho=rho, drho=drho, sqp_iters=sqp_iters,
                       merit=merit, gave_up=gave_up_any, pcg_iters=pcg_iters,
                       pcg_converged=pcg_converged, ls_alpha_idx=ls_alpha_idx)
    if tr:
        tr.finish(result)
    return result


def make_batched_fused_solver(model: RobotModel, cost: CostConfig,
                              sqp_cfg: SQPConfig, pcg_cfg: PCGConfig, dt: float,
                              integrator_type: int = 0):
    """fn(xu_b, lam_b, xs_b, ee_b, rho_b) -> batched SQPResult."""

    def solve(xu_b, lam_b, xs_b, ee_b, rho_b):
        return sqp_solve_batched_fused(model, cost, sqp_cfg, pcg_cfg, xu_b,
                                       lam_b, xs_b, ee_b, rho_b, dt,
                                       integrator_type=integrator_type)

    return solve


def sqp_solve_batched_fused_sharded(
    model: RobotModel,
    cost: CostConfig,
    sqp_cfg: SQPConfig,
    pcg_cfg: PCGConfig,
    xu_b, lam_b, xs_b, ee_b, rho_b, dt: float,
    mesh,
    instance_axis: str = "instance",
    integrator_type: int = 0,
    inst_per_prog: int | None = None,
) -> SQPResult:
    """The batched solve over the mesh's instance axis: each instance group
    held here (``mesh.instance_slices(B)``: all of them on a one-device
    ``KnotMesh``, this process's on a ``DistKnotMesh``) runs
    ``sqp_solve_batched_fused`` on its slab of B / n_instance problems, with
    no collective (independent problems never couple), and the groups'
    results are joined in order.  Port of the JAX function of this name,
    whose ``shard_map`` runs that slab on each device; the knot axis is not
    used (its in_specs shard the instance axis only).  Returns the SQPResult
    of the instances held here: on one device all B; on a ``DistKnotMesh``
    (one process and card per group, all groups at once) only this
    process's slab of B / n_instance, where the JAX function returns the
    global (B, ...) array sharded over the devices.  A caller who needs
    the whole batch on every process all-gathers the slabs; a knot axis of
    more than one process repeats the slab on each of its ranks.

    ``inst_per_prog`` (the TPU's lane packing of instances) has no
    counterpart on the card: accepted and ignored."""
    if instance_axis not in mesh.shape:
        raise ValueError(f"no {instance_axis!r} axis in the mesh {mesh.shape}")
    return over_instance_groups(
        mesh, lambda *slab: sqp_solve_batched_fused(
            model, cost, sqp_cfg, pcg_cfg, *slab, dt,
            integrator_type=integrator_type),
        xu_b, lam_b, xs_b, ee_b, rho_b)


def over_instance_groups(mesh, solve, *batch) -> SQPResult:
    """solve(*slab) on each instance group of the mesh held here (the same
    slice of every tensor of ``batch``), one group after another, the
    SQPResults joined along the instance axis."""
    parts = [solve(*(t[g] for t in batch))
             for g in mesh.instance_slices(batch[0].shape[0])]
    return SQPResult(*(torch.cat(field) for field in zip(*parts)))
