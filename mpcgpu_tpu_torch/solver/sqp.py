"""SQP outer loop: KKT -> Schur -> linear solve -> dz -> line search -> rho.

Port of ``mpcgpu_tpu/solver/sqp.py::sqp_solve``, with its routes (the JAX
package's ``"pallas"`` / ``"xla"`` are ``"cuda"`` / ``"plain"`` here):

  * ``fused`` (default: exactly when ``linsys="pcg_cuda"`` with the stair
    preconditioner): K1 build_kkt_schur -> K2 pcg_dz_solve, or with
    ``fused_dz=False`` K1 -> K2' pcg_solve_cuda -> K6 compute_dz_cuda;
  * not fused: KKT blocks (K5 build_kkt_cuda when the kernels are in use,
    else build_kkt) -> form_schur_system -> the linear solve -> compute_dz.
    The linear solves: ``"pcg"`` pcg_solve; ``"pcg_cuda"`` K2'
    pcg_solve_cuda; and the direct solvers, each counted as one iteration
    that converged: ``"ldl"`` btd_ldl_solve (block LDL^T, tensor ops),
    ``"pcr"`` pcr_solve_refined (PCR + one refinement, tensor ops),
    ``"pcr_cuda"`` K7 pcr_solve_cuda (the JAX package's ``"pcr_pallas"``),
    ``"qdldl_host"`` the reference's host round trip per iteration (S and
    gamma copied to the host, which synchronizes; the sparse LDL^T of
    ``native`` in f64; lam copied back);
  * merits: K3 line_search_merits_fused when the kernels are in use, else
    its plain version line_search_merits(include_zero=True).

``merit_impl="auto"`` uses the kernels (K5, K3) when xu is on the card and
the cost is in ee mode; ``"cuda"`` and ``"plain"`` force the choice.  Each
kernel wrapper launches its kernel on CUDA tensors and runs its plain
version on CPU tensors.

The merit argmin, the Levenberg-Marquardt rho schedule and the
Eisenstat-Walker forcing stay on the device as tensor ops.  The loop reads
its stop flag back to the host once per SQP iteration after the first; a
one-iteration solve (the MPC chain) never syncs.

One SQP iteration is ``_iteration``.  On the fused route with the K3
merits and xu on a card (``graph_engages``) the solve replays it as a CUDA
graph, one replay per iteration (``sqp_graph``); every other call runs it
eagerly, each iteration's launches enqueued by the host.  The loop and what
it carries are shared with the fleet's and the knot shards' solves
(``parallel/batched_cuda.py``, ``parallel/sqp_sharded.py``): each starts
from ``_initial_state``, runs ``_loop`` over its own iteration, writes the
per-iteration buffers by ``_record`` and returns ``_result``.  The fleet's
iteration takes the graph path by the same rule, through the same
``sqp_graph``.

Under a ``torch.profiler`` session the solve records the spans and counters
of ``utils/profiling.py`` (``sqp.solve``; per iteration ``sqp.kkt``,
``sqp.linsys``, ``sqp.dz`` off the fused K2 route, ``sqp.merits``,
``sqp.step``, ``sqp.stop_read``, or on the graph path ``sqp.replay`` and
``sqp.stop_read``); with none, one flag check per boundary.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.native import qdldl_solve_schur_cached
from mpcgpu_tpu_torch.ops.ldl import btd_ldl_solve
from mpcgpu_tpu_torch.ops.pcg import pcg_solve
from mpcgpu_tpu_torch.ops.pcg_cuda import (compute_dz_cuda, pcg_dz_solve,
                                           pcg_solve_cuda, pcg_solve_cuda_uncast)
from mpcgpu_tpu_torch.ops.pcr import pcr_solve_refined
from mpcgpu_tpu_torch.ops.pcr_cuda import pcr_solve_cuda
from mpcgpu_tpu_torch.ops.schur import compute_dz, form_schur_system
from mpcgpu_tpu_torch.solver.kkt import build_kkt
from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_cuda, build_kkt_schur
from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merits_fused,
                                                line_search_merits_plain)
from mpcgpu_tpu_torch.utils import profiling

# the JAX package's names for linsys values the port spells with "cuda"
_RENAMED = {"pcg_pallas": "pcg_cuda", "pcr_pallas": "pcr_cuda"}


def _qdldl_host(S, gamma):
    """The reference's per-iteration host round trip (qdldl/sqp.cuh:268-273):
    S and gamma to the host (a synchronizing copy, by design), the sparse
    LDL^T with the cached symbolic factorization in f64, lam back in the
    solve's dtype on the solve's device."""
    lam = qdldl_solve_schur_cached(S.cpu().numpy(), gamma.cpu().numpy())
    return torch.from_numpy(lam).to(device=gamma.device, dtype=gamma.dtype)


# the direct solvers: (S, gamma) -> lam
_DIRECT = {
    "ldl": btd_ldl_solve,
    "pcr": lambda S, gamma: pcr_solve_refined(S, gamma, refine=1),
    "pcr_cuda": lambda S, gamma: pcr_solve_cuda(S, gamma, refine=1),
    "qdldl_host": _qdldl_host,
}


class LineSearchStep(NamedTuple):
    success: torch.Tensor      # the best candidate lowers the merit
    alpha: torch.Tensor        # its step length
    alpha_idx: torch.Tensor    # int32 its index among the alphas (-1 = fail)
    merit_cur: torch.Tensor    # the current iterate's merit
    min_merit: torch.Tensor    # the best candidate's merit
    merit: torch.Tensor        # the merit after the step
    rho: torch.Tensor          # the next rho
    drho: torch.Tensor         # the next L-M rho multiplier
    stop: torch.Tensor         # bool, the step failed and rho exceeded rho_max


def line_search_update(merits, alphas, rho, drho, sqp_cfg: SQPConfig) -> LineSearchStep:
    """One SQP iteration's line-search choice and Levenberg-Marquardt rho
    schedule, elementwise over any leading instance axes: merits and alphas
    (..., 1 + num_alphas) with the current iterate's merit (alpha 0) first,
    rho and drho (...).  Shared by ``sqp_solve`` and the batched loop."""
    merit_cur = merits[..., 0]
    best = 1 + torch.argmin(merits[..., 1:], dim=-1, keepdim=True)
    # gather, not merits[best]: indexing with a tensor reads it back to the
    # host and synchronizes the stream
    min_merit = merits.gather(-1, best)[..., 0]
    success = min_merit < merit_cur
    drho_fail = torch.clamp(drho * sqp_cfg.rho_factor, min=sqp_cfg.rho_factor)
    rho_fail = torch.clamp(rho * drho_fail, min=sqp_cfg.rho_min)
    gave_up = rho_fail > sqp_cfg.rho_max
    drho_ok = torch.clamp(drho / sqp_cfg.rho_factor, max=1.0 / sqp_cfg.rho_factor)
    rho_ok = torch.clamp(rho * drho_ok, min=sqp_cfg.rho_min)
    rho_reset = torch.full_like(rho, sqp_cfg.rho_reset)
    return LineSearchStep(
        success=success, alpha=alphas.gather(-1, best)[..., 0],
        alpha_idx=torch.where(success, best[..., 0] - 1, -1).to(torch.int32),
        merit_cur=merit_cur, min_merit=min_merit,
        merit=torch.where(success, min_merit, merit_cur),
        rho=torch.where(success, rho_ok, torch.where(gave_up, rho_reset, rho_fail)),
        drho=torch.where(success, drho_ok, drho_fail),
        stop=~success & gave_up)


class SQPResult(NamedTuple):
    xu: torch.Tensor            # (N, nx+nu) updated iterate
    lam: torch.Tensor           # (N, nx) updated multipliers
    rho: torch.Tensor           # () updated regularization
    drho: torch.Tensor          # () updated L-M rho multiplier
    sqp_iters: torch.Tensor     # () int32 iterations performed
    merit: torch.Tensor         # () final merit value
    gave_up: torch.Tensor       # () bool, rho exceeded rho_max
    pcg_iters: torch.Tensor     # (max_sqp_iter,) int32 per-iteration PCG iters (-1 pad)
    pcg_converged: torch.Tensor  # (max_sqp_iter,) bool per-iteration exit flag
    ls_alpha_idx: torch.Tensor  # (max_sqp_iter,) int32 chosen alpha index (-1 = fail)


class _Route(NamedTuple):
    """What a solve's SQP iterations read besides the carried state: the
    problem, the settings and the route (module docstring)."""
    model: RobotModel
    cost: CostConfig
    sqp_cfg: SQPConfig
    pcg_cfg: PCGConfig
    xs: torch.Tensor
    ee_goal: torch.Tensor
    dt: float
    linsys: str
    integrator_type: int
    angle_wrap: bool
    use_kernels: bool
    fused: bool
    fused_dz: bool
    exit_tol_target: torch.Tensor   # () pcg_cfg.exit_tol
    one_iter: torch.Tensor | None   # () int32 1: a direct solve's iterations
    converged: torch.Tensor | None  # () bool True: and its exit flag


class _State(NamedTuple):
    """What an SQP loop carries from one iteration to the next, for one arm
    or with a leading instance axis (``_initial_state``): first the fields
    an iteration returns anew, then the iteration count and the result's
    per-iteration buffers, whose entries each iteration writes in place
    (``_record``).  ``SQPResult``'s fields are among them (``_result``)."""
    xu: torch.Tensor
    lam: torch.Tensor
    rho: torch.Tensor
    drho: torch.Tensor
    merit: torch.Tensor
    stop: torch.Tensor
    gave_up: torch.Tensor
    lin_tol: torch.Tensor
    sqp_iters: torch.Tensor
    pcg_iters: torch.Tensor
    pcg_converged: torch.Tensor
    ls_alpha_idx: torch.Tensor


def _initial_state(xu, lam, rho, drho, exit_tol, max_iter: int,
                   pcg_cfg: PCGConfig | None = None) -> _State:
    """The state before an SQP loop's first iteration.  The leading
    instance shape is rho's, () for one arm and (B,) for a fleet; drho is a
    tensor of that shape.  Merit inf, no stop, nothing given up, no
    iterations, the per-iteration buffers (max_iter entries an instance)
    -1, False and -1, and the linear solve's tolerance the 0-d exit_tol,
    times ``pcg_cfg.ew_boost0`` where ``pcg_cfg`` forces by Eisenstat-Walker
    (the fleet and the knot shards pass none: their tolerance is fixed)."""
    batch, dev, dtype = rho.shape, xu.device, xu.dtype
    i32, b8 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.bool, device=dev)
    ew = pcg_cfg is not None and pcg_cfg.forcing == "ew"
    return _State(
        xu=xu, lam=lam, rho=rho, drho=drho,
        merit=torch.full(batch, float("inf"), dtype=dtype, device=dev),
        stop=torch.zeros(batch, **b8), gave_up=torch.zeros(batch, **b8),
        lin_tol=exit_tol * pcg_cfg.ew_boost0 if ew else exit_tol,
        sqp_iters=torch.zeros(batch, **i32),
        pcg_iters=torch.full(batch + (max_iter,), -1, **i32),
        pcg_converged=torch.zeros(batch + (max_iter,), **b8),
        ls_alpha_idx=torch.full(batch + (max_iter,), -1, **i32))


def _put(buf, it, value) -> None:
    """buf[..., it] = value, for ``it`` a Python int or a device int64 (1,)
    (an index the card reads, so that one captured graph writes the entry
    of whichever iteration it replays), over one arm's (max_iter,) buffer
    or a fleet's (B, max_iter)."""
    if isinstance(it, int):
        buf[..., it] = value
    else:
        buf.index_copy_(buf.dim() - 1, it,
                        value.reshape(buf.shape[:-1] + (1,)).to(buf.dtype))


def _at(buf, it):
    """buf[..., it], for ``it`` as ``_put`` takes it."""
    if isinstance(it, int):
        return buf[..., it]
    return buf.index_select(-1, it)[..., 0]


def _record(st: _State, it, lin_iters, lin_ok, alpha_idx) -> None:
    """SQP iteration ``it``'s entries of the per-iteration buffers: the
    linear solve's iterations and exit flag, the chosen alpha's index."""
    _put(st.pcg_iters, it, lin_iters)
    _put(st.pcg_converged, it, lin_ok)
    _put(st.ls_alpha_idx, it, alpha_idx)


def _loop(iterate, st: _State, iter_bound: int, tr=None):
    """The SQP loop of every solve: ``st = iterate(st, it, tr)`` for it = 0,
    1, ... while ``it < iter_bound``, the stop flag read back to the host
    before every iteration after the first (a batch's: whether every
    instance stopped).  Returns the final state and the iterations run."""
    it = 0
    while it < iter_bound:
        if it:
            if tr:
                tr.phase("sqp.stop_read", it - 1)
            stop = st.stop
            if bool(stop.all() if stop.dim() else stop):
                break
        st = iterate(st, it, tr)
        it += 1
    return st, it


def _result(st: _State) -> SQPResult:
    """The result's fields of a final state."""
    return SQPResult._make(getattr(st, f) for f in SQPResult._fields)


def _iteration(r: _Route, st: _State, it, tr=None) -> _State:
    """One SQP iteration from ``st`` on ``r``'s route: the KKT system, the
    linear solve and dz, the merits, the line-search step and rho, the
    Eisenstat-Walker forcing, and the iteration's entries of the
    per-iteration buffers (at ``it``, ``_record``).  Returns the next state;
    the iteration count is the loop's.  The eager loop (``_loop``) runs it
    with ``it`` an int and the solve's recorder ``tr``; ``sqp_graph``
    captures it with ``it`` on the card and no recorder."""
    xu, lam, rho = st.xu, st.lam, st.rho
    cost, pcg_cfg, sqp_cfg = r.cost, r.pcg_cfg, r.sqp_cfg
    nx = lam.shape[-1]
    if tr:
        tr.phase("sqp.kkt", it)
    pcg_kw = dict(max_iter=pcg_cfg.max_iter, exit_tol=st.lin_tol,
                  exit_criterion=pcg_cfg.exit_criterion)
    if r.fused:
        sys = build_kkt_schur(r.model, cost, xu, r.xs, r.ee_goal, rho, r.dt,
                              r.integrator_type, r.angle_wrap)
        if tr:
            tr.phase("sqp.linsys")
        if r.fused_dz:
            lam, dz, lin_iters, lin_ok = pcg_dz_solve(
                sys, lam, xu[:, nx:], rho, cost.r_cost, **pcg_kw)
        else:
            # K2''s exit flag stays int32 until pcg_converged[it] casts
            # it, so that K6 follows K2' in the stream
            lam, lin_iters, lin_ok = pcg_solve_cuda_uncast(
                sys["S"], sys["Pinv"], sys["gamma"], lam, **pcg_kw)
            if tr:
                tr.phase("sqp.dz")
            dz = compute_dz_cuda(sys, lam, xu[:, nx:], rho, cost.r_cost)
    else:
        make_kkt = build_kkt_cuda if r.use_kernels else build_kkt
        kkt = make_kkt(r.model, cost, xu, r.xs, r.ee_goal, r.dt,
                       r.integrator_type, r.angle_wrap)
        schur = form_schur_system(kkt, rho,
                                  preconditioner=pcg_cfg.preconditioner)
        if tr:
            tr.phase("sqp.linsys")
        if r.linsys in _DIRECT:
            lam = _DIRECT[r.linsys](schur.S, schur.gamma)
            lin_iters, lin_ok = r.one_iter, r.converged
        else:
            solve = pcg_solve_cuda if r.linsys == "pcg_cuda" else pcg_solve
            lam, lin_iters, lin_ok = solve(schur.S, schur.Pinv, schur.gamma,
                                           lam, **pcg_kw)
        if tr:
            tr.phase("sqp.dz")
        dz = compute_dz(kkt, schur, lam)
    if tr:
        tr.lam_solved(lam)
        tr.phase("sqp.merits")
    search = (line_search_merits_fused if r.use_kernels
              else line_search_merits_plain)
    merits, alphas = search(
        r.model, cost, xu, dz, r.xs, r.ee_goal, float(sqp_cfg.mu), r.dt,
        num_alphas=sqp_cfg.num_alphas, integrator_type=r.integrator_type,
        angle_wrap=r.angle_wrap)

    if tr:
        tr.phase("sqp.step")
    step = line_search_update(merits, alphas, rho, st.drho, sqp_cfg)
    xu = torch.where(step.success, xu + step.alpha * dz, xu)
    gave_up = st.gave_up | step.stop

    # Eisenstat-Walker-style forcing: decay the linear-solve tolerance
    # with the merit-decrease ratio; a failed line search drops straight
    # to full accuracy
    lin_tol = st.lin_tol
    if pcg_cfg.forcing == "ew":
        ratio = torch.clamp(step.min_merit / torch.clamp(step.merit_cur, min=1e-30),
                            0.0, 1.0)
        factor = torch.clamp(torch.pow(ratio, pcg_cfg.ew_alpha),
                             max=pcg_cfg.ew_decay)
        decayed = torch.maximum(r.exit_tol_target, lin_tol * factor)
        lin_tol = torch.where(step.success, decayed, r.exit_tol_target)

    _record(st, it, lin_iters, lin_ok, step.alpha_idx)
    return st._replace(xu=xu, lam=lam, rho=step.rho, drho=step.drho,
                       merit=step.merit, stop=step.stop, gave_up=gave_up,
                       lin_tol=lin_tol)


def sqp_solve(
    model: RobotModel,
    cost: CostConfig,
    sqp_cfg: SQPConfig,
    pcg_cfg: PCGConfig,
    xu,
    lam,
    xs,
    ee_goal,
    rho,
    dt: float,
    linsys: str = "pcg",
    max_sqp_iter: int | None = None,
    integrator_type: int = 0,
    drho0=1.0,
    angle_wrap: bool = False,
    iter_budget=None,
    merit_impl: str = "auto",
    fused: bool | None = None,
    fused_dz: bool = True,
) -> SQPResult:
    """One SQP solve from the iterate (xu, lam).

    rho and drho0 may be floats or 0-d tensors.  iter_budget is an optional
    iteration cap <= max_iter (the equivalent of the reference's wall-clock
    exit once converted to iterations).  merit_impl, fused and fused_dz pick
    the route (module docstring).  On the fused route with the K3 merits
    and xu on a card, each SQP iteration is one replay of a CUDA graph
    (``sqp_graph``); every other call runs the iterations eagerly.  Both
    run ``_iteration``, with the same results.
    """
    if linsys in _RENAMED:
        raise NotImplementedError(
            f"linsys={linsys!r} is the JAX package's name; the port's kernel "
            f"route is linsys={_RENAMED[linsys]!r} (see ROADMAP.md)")
    if linsys not in ("pcg", "pcg_cuda") and linsys not in _DIRECT:
        raise ValueError(f"unknown linsys {linsys!r}")
    if merit_impl == "auto":
        use_kernels = xu.device.type == "cuda" and cost.mode == "ee"
    elif merit_impl in ("cuda", "plain"):
        use_kernels = merit_impl == "cuda"
    else:
        raise ValueError(f"unknown merit_impl {merit_impl!r}")
    if fused is None:
        fused = linsys == "pcg_cuda" and pcg_cfg.preconditioner == "stair"
    if fused and pcg_cfg.preconditioner != "stair":
        raise ValueError("the fused route (K1 -> K2) supports "
                         "preconditioner='stair' only")
    if fused and linsys in _DIRECT:
        raise ValueError(f"the fused route solves by PCG; linsys={linsys!r} "
                         "runs unfused")
    max_iter = sqp_cfg.max_iter if max_sqp_iter is None else max_sqp_iter
    iter_bound = max_iter if iter_budget is None else min(max_iter, int(iter_budget))
    if graph_engages(fused, use_kernels, xu):
        from mpcgpu_tpu_torch.solver import sqp_graph

        return sqp_graph.solve(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs,
                               ee_goal, rho, dt, max_iter, iter_bound,
                               integrator_type, drho0, angle_wrap, fused_dz)
    return _solve_eager(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_goal,
                        rho, dt, linsys, max_iter, iter_bound, integrator_type,
                        drho0, angle_wrap, use_kernels, fused, fused_dz)


def _solve_eager(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_goal, rho, dt,
                 linsys: str, max_iter: int, iter_bound: int,
                 integrator_type: int, drho0, angle_wrap: bool,
                 use_kernels: bool, fused: bool, fused_dz: bool) -> SQPResult:
    """``sqp_solve``'s loop with every iteration enqueued by the host (the
    route checked and resolved by the caller)."""
    tr = profiling.solve_trace(1)
    dev, dtype = xu.device, xu.dtype
    exit_tol_target = _kernels.scalar(pcg_cfg.exit_tol, dev, dtype)
    st = _initial_state(xu, lam, _kernels.scalar(rho, dev, dtype),
                        _kernels.scalar(drho0, dev, dtype), exit_tol_target,
                        max_iter, pcg_cfg)
    r = _Route(model, cost, sqp_cfg, pcg_cfg, xs, ee_goal, dt, linsys,
               integrator_type, angle_wrap, use_kernels, fused, fused_dz,
               exit_tol_target,
               one_iter=torch.ones((), dtype=torch.int32, device=dev),
               converged=torch.ones((), dtype=torch.bool, device=dev))
    st, it = _loop(functools.partial(_iteration, r), st, iter_bound, tr)
    st.sqp_iters.fill_(it)
    result = _result(st)
    if tr:
        tr.finish(result)
    return result


def graph_engages(fused: bool, use_kernels: bool, xu) -> bool:
    """Whether a solve runs its iterations as CUDA graph replays: exactly
    on the fused route (K1 -> K2, or K2' -> K6; the fleet's K8a -> K8b ->
    K8c) with the K3 merits (the fleet's K3b) and xu on a card.  The direct
    solvers, the unfused PCG, the plain merits and CPU tensors run
    eagerly."""
    return fused and use_kernels and xu.device.type == "cuda"


def make_sqp_solver(model: RobotModel, cost: CostConfig, sqp_cfg: SQPConfig,
                    pcg_cfg: PCGConfig, dt: float, linsys: str = "pcg",
                    integrator_type: int = 0, angle_wrap: bool = False,
                    merit_impl: str = "auto", fused: bool | None = None,
                    fused_dz: bool = True):
    """A solver fn(xu, lam, xs, ee_goal, rho[, drho0[, iter_budget]]) ->
    SQPResult with the model, configuration and route bound."""

    def solve(xu, lam, xs, ee_goal, rho, drho0=1.0, iter_budget=None):
        return sqp_solve(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_goal,
                         rho, dt, linsys=linsys, integrator_type=integrator_type,
                         drho0=drho0, angle_wrap=angle_wrap,
                         iter_budget=iter_budget, merit_impl=merit_impl,
                         fused=fused, fused_dz=fused_dz)

    return solve
