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

Under a ``torch.profiler`` session the solve records the spans and counters
of ``utils/profiling.py`` (``sqp.solve``; per iteration ``sqp.kkt``,
``sqp.linsys``, ``sqp.dz`` off the fused K2 route, ``sqp.merits``,
``sqp.step``, ``sqp.stop_read``); with none, one flag check per boundary.
"""

from __future__ import annotations

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
    the route (module docstring).
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

    tr = profiling.solve_trace(1)
    dev, dtype = xu.device, xu.dtype
    nx = lam.shape[-1]
    max_iter = sqp_cfg.max_iter if max_sqp_iter is None else max_sqp_iter
    iter_bound = max_iter if iter_budget is None else min(max_iter, int(iter_budget))

    rho = _kernels.scalar(rho, dev, dtype)
    drho = _kernels.scalar(drho0, dev, dtype)
    mu = float(sqp_cfg.mu)
    exit_tol_target = _kernels.scalar(pcg_cfg.exit_tol, dev, dtype)
    lin_tol = exit_tol_target * pcg_cfg.ew_boost0 if pcg_cfg.forcing == "ew" \
        else exit_tol_target
    merit = _kernels.scalar(float("inf"), dev, dtype)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    gave_up_any = torch.zeros((), dtype=torch.bool, device=dev)
    pcg_iters = torch.full((max_iter,), -1, dtype=torch.int32, device=dev)
    pcg_converged = torch.zeros((max_iter,), dtype=torch.bool, device=dev)
    ls_alpha_idx = torch.full((max_iter,), -1, dtype=torch.int32, device=dev)
    # what a direct solve records as its iteration count and exit flag
    one_iter = torch.ones((), dtype=torch.int32, device=dev)
    converged = torch.ones((), dtype=torch.bool, device=dev)

    it = 0
    while it < iter_bound:
        if it:
            if tr:
                tr.phase("sqp.stop_read", it - 1)
            if bool(stop):
                break
        if tr:
            tr.phase("sqp.kkt", it)
        pcg_kw = dict(max_iter=pcg_cfg.max_iter, exit_tol=lin_tol,
                      exit_criterion=pcg_cfg.exit_criterion)
        if fused:
            sys = build_kkt_schur(model, cost, xu, xs, ee_goal, rho, dt,
                                  integrator_type, angle_wrap)
            if tr:
                tr.phase("sqp.linsys")
            if fused_dz:
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
            make_kkt = build_kkt_cuda if use_kernels else build_kkt
            kkt = make_kkt(model, cost, xu, xs, ee_goal, dt, integrator_type,
                           angle_wrap)
            schur = form_schur_system(kkt, rho,
                                      preconditioner=pcg_cfg.preconditioner)
            if tr:
                tr.phase("sqp.linsys")
            if linsys in _DIRECT:
                lam = _DIRECT[linsys](schur.S, schur.gamma)
                lin_iters, lin_ok = one_iter, converged
            else:
                solve = pcg_solve_cuda if linsys == "pcg_cuda" else pcg_solve
                lam, lin_iters, lin_ok = solve(schur.S, schur.Pinv, schur.gamma,
                                               lam, **pcg_kw)
            if tr:
                tr.phase("sqp.dz")
            dz = compute_dz(kkt, schur, lam)
        if tr:
            tr.lam_solved(lam)
            tr.phase("sqp.merits")
        search = (line_search_merits_fused if use_kernels
                  else line_search_merits_plain)
        merits, alphas = search(
            model, cost, xu, dz, xs, ee_goal, mu, dt,
            num_alphas=sqp_cfg.num_alphas, integrator_type=integrator_type,
            angle_wrap=angle_wrap)

        if tr:
            tr.phase("sqp.step")
        step = line_search_update(merits, alphas, rho, drho, sqp_cfg)
        xu = torch.where(step.success, xu + step.alpha * dz, xu)
        rho, drho, merit, stop = step.rho, step.drho, step.merit, step.stop
        gave_up_any = gave_up_any | stop

        # Eisenstat-Walker-style forcing: decay the linear-solve tolerance
        # with the merit-decrease ratio; a failed line search drops straight
        # to full accuracy
        if pcg_cfg.forcing == "ew":
            ratio = torch.clamp(step.min_merit / torch.clamp(step.merit_cur, min=1e-30),
                                0.0, 1.0)
            factor = torch.clamp(torch.pow(ratio, pcg_cfg.ew_alpha),
                                 max=pcg_cfg.ew_decay)
            decayed = torch.maximum(exit_tol_target, lin_tol * factor)
            lin_tol = torch.where(step.success, decayed, exit_tol_target)

        pcg_iters[it] = lin_iters
        pcg_converged[it] = lin_ok
        ls_alpha_idx[it] = step.alpha_idx
        it += 1

    result = SQPResult(
        xu=xu, lam=lam, rho=rho, drho=drho,
        sqp_iters=torch.full((), it, dtype=torch.int32, device=dev),
        merit=merit, gave_up=gave_up_any, pcg_iters=pcg_iters,
        pcg_converged=pcg_converged, ls_alpha_idx=ls_alpha_idx)
    if tr:
        tr.finish(result)
    return result


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
