"""Knot-sharded SQP: the whole iteration split over knot shards.

Port of ``mpcgpu_tpu/parallel/sqp_sharded.py``, the long-horizon path
(BASELINE config 4: N = 512 row-partitioned with halo exchange).  KKT
assembly and the cost blocks are knot-parallel; the Schur condensation, dz
recovery and merit defects each need one neighbour block-row per stage
(ring sends); the line-search merits and the CG dots reduce with psum.  The
body runs on local tensors with a leading shard axis against a mesh
(``parallel/mesh.py``: ``KnotMesh`` on one device, ``DistKnotMesh`` across
processes), and its semantics are ``solver/sqp.py::sqp_solve(linsys="pcg")``
with the fixed PCG exit tolerance, as in the JAX package.

Two routes for the shard-local compute:

  * unfused: the plain blocks (``euler_step_and_jacobians``,
    ``tracking_cost_grad_hess``), Schur condensation with the stair, jacobi
    or no preconditioner, ``compute_dz`` and the merits, with a sharded PCG
    (``parallel/pcg_sharded.py``);
  * fused: each shard's slab extended by two halo knots per side through
    K9a (``build_kkt_schur_slab``), the PCG fed K9a's blocks in place (by
    default the s-step CG through K10b and its coefficient step; the
    pipelined CG through K10a), dz through K9b (``compute_dz_slab``), and
    the merits' per-knot terms through K9c
    (``line_search_merit_partials_slab``), summed with the boundary
    corrections and one psum.

``fused="auto"`` takes the fused route when the tensors are on the card and
the shape qualifies (ee cost, stair preconditioner, L >= 2), else the
unfused one (on the CPU the wrappers would run their plain versions).  The
loop reads its stop flag back once per SQP iteration after the first, as
``sqp_solve`` does; the PCG reads nothing back.
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.ops.pcg_cuda import compute_dz_slab
from mpcgpu_tpu_torch.ops.pcg_slab import block_mv as _mv
from mpcgpu_tpu_torch.ops.smallmat import gj_inverse
from mpcgpu_tpu_torch.parallel.pcg_sharded import local_pcg
from mpcgpu_tpu_torch.solver.kkt import (euler_step_and_jacobians,
                                         integrator_step,
                                         tracking_cost_grad_hess)
from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur_slab
from mpcgpu_tpu_torch.solver.merit import line_search_alphas, tracking_cost
from mpcgpu_tpu_torch.solver.merit_cuda import line_search_merit_partials_slab
from mpcgpu_tpu_torch.solver.sqp import SQPResult, line_search_update

H = 2   # halo knots per side of a fused slab (the stair band's two-hop need)


def _mtv(M, v):
    return torch.einsum("...ji,...j->...i", M, v)


def _prev(v, left):
    """The rows k-1 of a slab (n_local, L, ...), the first from ``left``."""
    return torch.cat([left[:, None], v[:, :-1]], dim=1)


def _next(v, right):
    """The rows k+1 of a slab, the last from ``right``."""
    return torch.cat([v[:, 1:], right[:, None]], dim=1)


def _resolve_route(xu, cost: CostConfig, pcg_cfg: PCGConfig, L: int, fused,
                  pcg_method: str, pcg_s_steps: int):
    """(fused, the PCG method) as the JAX package resolves them, with the
    card in the TPU's place: see ``sqp_solve_sharded``."""
    if fused == "auto":
        fused = (xu.device.type == "cuda" and cost.mode == "ee"
                 and pcg_cfg.preconditioner == "stair" and L >= 2)
    if fused:
        if cost.mode != "ee" or pcg_cfg.preconditioner != "stair":
            raise ValueError(
                "fused sharded SQP requires ee cost mode and the stair "
                "preconditioner (the slab kernel emits stair Pinv)")
        if L < 2:
            raise ValueError(f"fused slab path needs slab length >= 2, got {L}")
    if pcg_method == "auto":
        pcg_method = ("ca_slab" if fused and L >= 2 * pcg_s_steps + 1
                      else "pipelined")
    if pcg_method.startswith("ca") and L < 2 * pcg_s_steps + 1:
        pcg_method = "pipelined"       # the packets carry 2s+1 rows a side
    if fused and pcg_method == "pipelined":
        pcg_method = "pipelined_slab"
    return bool(fused), pcg_method


def sqp_solve_sharded(
    model: RobotModel,
    cost: CostConfig,
    sqp_cfg: SQPConfig,
    pcg_cfg: PCGConfig,
    xu, lam, xs, ee_goal, rho, dt,
    mesh,
    integrator_type: int = 0,
    knot_axis: str = "knot",
    iter_budget=None,
    fused: bool | str = "auto",
    pcg_method: str = "auto",
    pcg_s_steps: int = 4,
) -> SQPResult:
    """Full SQP solve with (N, ...) arrays split over ``mesh``'s knot shards.

    iter_budget: an optional iteration cap <= sqp_cfg.max_iter (as
    ``sqp_solve``'s).  fused: the kernels' slab route ("auto": on the card
    when the shape qualifies; module docstring).  pcg_method: "pipelined"
    (Chronopoulos-Gear; on the fused route its slab kernel K10a),
    "pipelined_slab", "classic", the s-step "ca" / "ca_slab" (s =
    pcg_s_steps; on the fused route "ca_slab" runs K10b and its coefficient
    step on K9a's blocks in place); "auto" resolves as the JAX package
    does, to "ca_slab" on the fused route when L >= 2 pcg_s_steps + 1, else
    "pipelined", and the s-step forms fall back to "pipelined" below that
    width.  rho may be a float or a 0-d tensor.  Returns an ``SQPResult``
    over the full arrays.
    """
    if knot_axis != "knot":
        raise ValueError(f"the knot meshes have one axis, 'knot'; got {knot_axis!r}")
    N = xu.shape[0]
    nq = model.nq
    nx = 2 * nq
    dev, dtype = xu.device, xu.dtype
    n_shard = mesh.size
    if N % n_shard:
        raise ValueError(f"N={N} not divisible by {n_shard} knot shards")
    if pcg_cfg.preconditioner not in ("stair", "jacobi", "none"):
        raise ValueError(f"unknown preconditioner {pcg_cfg.preconditioner!r}")
    L = N // n_shard
    fused, pcg_method = _resolve_route(xu, cost, pcg_cfg, L, fused, pcg_method,
                                      pcg_s_steps)
    solve_lin = local_pcg(pcg_method, L, pcg_s_steps)
    max_iter = sqp_cfg.max_iter
    iter_bound = max_iter if iter_budget is None else min(max_iter, int(iter_budget))
    mu = float(sqp_cfg.mu)
    alphas = line_search_alphas(sqp_cfg.num_alphas, True, dtype, dev)
    tol = _kernels.scalar(pcg_cfg.exit_tol, dev, dtype)

    shard = mesh.shard_ids(dev)                              # (n_local,)
    gpos = shard[:, None] * L + torch.arange(L, device=dev)  # global knots
    is_g0, is_gl = gpos == 0, gpos == N - 1
    on_first, on_last = shard == 0, shard == n_shard - 1
    xu_loc, lam_loc = mesh.scatter(xu), mesh.scatter(lam)
    ee_loc = mesh.scatter(ee_goal)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def build_blocks(xu_loc):
        x, u = xu_loc[..., :nx], xu_loc[..., nx:]
        xnext, A, B = euler_step_and_jacobians(model, x, u, dt, integrator_type)
        x_eval = x
        if not cost.terminal_at_last_state:
            # the terminal quirk: the global LAST knot's cost blocks at
            # x_{N-2}, the previous local row or, at L = 1, the left
            # neighbour's
            prev_row = x[:, -2] if L >= 2 else mesh.send_right(x[:, -1])
            x_eval = torch.where(is_gl[..., None], prev_row[:, None], x)
        Q, q, R, r = tracking_cost_grad_hess(model, cost, x_eval, u, ee_loc)
        # defect c_k = x_k - xnext_{k-1}; the global row 0: x_0 - xs
        xnext_prev = _prev(xnext, mesh.send_right(xnext[:, -1]))
        c = torch.where(is_g0[..., None], x - xs, x - xnext_prev)
        return A, B, Q, q, R, r, c

    def form_schur(A, B, Q, q, R, r, c, rho):
        Qinv = gj_inverse(Q + rho * torch.eye(nx, dtype=dtype, device=dev))
        Rinv = gj_inverse(R + rho * torch.eye(nq, dtype=dtype, device=dev))
        AQ, BR = A @ Qinv, B @ Rinv
        T = AQ @ A.transpose(-1, -2) + BR @ B.transpose(-1, -2)
        aqq, brr = _mv(AQ, q), _mv(BR, r)
        # one packed halo row from the left neighbour: T, AQ, AQ q, BR r
        nn = nx * nx
        packet = torch.cat([T[:, -1].reshape(-1, nn), AQ[:, -1].reshape(-1, nn),
                            aqq[:, -1], brr[:, -1]], dim=-1)
        left = mesh.send_right(packet)
        T_prev = _prev(T, left[:, :nn].reshape(-1, nx, nx))
        AQ_prev = _prev(AQ, left[:, nn:2 * nn].reshape(-1, nx, nx))
        aqq_prev = _prev(aqq, left[:, 2 * nn:2 * nn + nx])
        brr_prev = _prev(brr, left[:, 2 * nn + nx:])
        g0, gl = is_g0[..., None, None], is_gl[..., None, None]
        z_blk = torch.zeros_like(Qinv)
        theta = Qinv + torch.where(g0, z_blk, T_prev)
        phi = torch.where(g0, z_blk, -AQ_prev)
        phiT = torch.where(gl, z_blk, -AQ.transpose(-1, -2))
        gamma = _mv(Qinv, q) - torch.where(is_g0[..., None], zero,
                                           c + aqq_prev + brr_prev)
        S = torch.stack([phi, theta, phiT], dim=2)
        if pcg_cfg.preconditioner == "none":
            eye = torch.eye(nx, dtype=dtype, device=dev).expand_as(theta)
            return S, torch.stack([z_blk, eye, z_blk], dim=2), gamma, Qinv, Rinv
        D = gj_inverse(theta)
        if pcg_cfg.preconditioner == "jacobi":
            return S, torch.stack([z_blk, D, z_blk], dim=2), gamma, Qinv, Rinv
        # the stair bands need both neighbours' D
        D_prev = _prev(D, mesh.send_right(D[:, -1]))
        D_next = _next(D, mesh.send_left(D[:, 0]))
        left_b = torch.where(g0, z_blk, -((D @ phi) @ D_prev))
        right_b = torch.where(gl, z_blk, -((D @ phiT) @ D_next))
        return S, torch.stack([left_b, D, right_b], dim=2), gamma, Qinv, Rinv

    def compute_dz(A, B, q, r, Qinv, Rinv, lam_loc):
        lam_next = _next(lam_loc, mesh.send_left(lam_loc[:, 0]))
        rhs_x = q - lam_loc + torch.where(is_gl[..., None], zero, _mtv(A, lam_next))
        du = _mv(Rinv, r + _mtv(B, lam_next))
        return torch.cat([_mv(Qinv, rhs_x),
                          torch.where(is_gl[..., None], zero, du)], dim=-1)

    def merits_of(xu_loc, dz_loc):
        """l1-penalty merits of all alphas; one halo + one psum."""
        # the next global knot's candidate state, per alpha
        right = mesh.send_left(torch.cat([xu_loc[:, 0, :nx], dz_loc[:, 0, :nx]], -1))
        x0r, dz0r = right[:, :nx], right[:, nx:]
        a4 = alphas[None, :, None, None]
        cand = xu_loc[:, None] + a4 * dz_loc[:, None]         # (n, A, L, w)
        x, u = cand[..., :nx], cand[..., nx:]
        xn = integrator_step(model, x, u, dt, integrator_type)
        x_after = x0r[:, None] + alphas[None, :, None] * dz0r[:, None]
        x_next = torch.cat([x[:, :, 1:], x_after[:, :, None]], dim=2)
        defect = torch.sum(torch.abs(x_next - xn), dim=-1)
        defect = torch.where(is_gl[:, None], zero, defect)
        J = tracking_cost(model, cost, cand, ee_loc[:, None])
        # tracking_cost drops its own last row's control term by LOCAL
        # position; only the last shard's is the global last: add it back
        # elsewhere
        extra = 0.5 * cost.r_cost * torch.sum(cand[:, :, -1, nx:] ** 2, dim=-1)
        J = J + torch.where(on_last[:, None], zero, extra)
        x0_res = torch.where(on_first[:, None],
                             torch.sum(torch.abs(x[:, :, 0] - xs), dim=-1), zero)
        return mesh.psum(J + mu * (defect.sum(-1) + x0_res))

    if fused:
        gmod = torch.remainder(shard[:, None] * L
                               + torch.arange(-H, L + H, device=dev), N)
        first_ext, last_ext = (gmod == 0).to(dtype), (gmod == N - 1).to(dtype)
        last_loc = is_gl.to(dtype)

        def halo2(v):
            """A slab with two ring-halo rows per side (the wrap-around rows
            at the global edges meet only masked terms)."""
            return torch.cat([mesh.send_right(v[:, -H:]), v,
                              mesh.send_left(v[:, :H])], dim=1)

        ee_ext = halo2(ee_loc)                                # loop-invariant
        ee_e = torch.cat([ee_loc, ee_loc[:, :1]], dim=1)

    def build_fused(xu_loc, rho):
        lane = build_kkt_schur_slab(model, cost, halo2(xu_loc), ee_ext,
                                    first_ext, last_ext, rho, dt,
                                    integrator_type)
        return {k: v[:, H:H + L] for k, v in lane.items()}

    def dz_fused(lane, xu_loc, lam_new, rho):
        lam_next = _next(lam_new, mesh.send_left(lam_new[:, 0]))
        return compute_dz_slab(lane, lam_new, lam_next, last_loc,
                               xu_loc[..., nx:], rho, cost.r_cost)

    def merits_fused(xu_loc, dz_loc):
        """K9c's per-knot terms + the boundary corrections + one psum."""
        right = mesh.send_left(torch.cat([xu_loc[:, 0], dz_loc[:, 0]], dim=-1))
        w = xu_loc.shape[-1]
        xu_e = torch.cat([xu_loc, right[:, None, :w]], dim=1)
        dz_e = torch.cat([dz_loc, right[:, None, w:]], dim=1)
        cost_pl, defect_pl, _ = line_search_merit_partials_slab(
            model, cost, xu_e, dz_e, ee_e, dt, num_alphas=sqp_cfg.num_alphas,
            integrator_type=integrator_type)
        cost_pl, defect_pl = cost_pl[..., :L], defect_pl[..., :L]   # drop the halo
        # K9c's per-knot cost has the control term at every knot of the
        # slab; the global LAST knot has none
        cand_u = xu_loc[:, None, :, nx:] + alphas[None, :, None, None] \
            * dz_loc[:, None, :, nx:]
        extra = 0.5 * cost.r_cost * torch.sum(
            last_loc[:, None, :, None] * cand_u * cand_u, dim=(2, 3))
        cost_tot = cost_pl.sum(-1) - extra
        defect_tot = torch.sum(defect_pl * (1.0 - last_loc)[:, None], dim=-1)
        cand_x0 = xu_loc[:, None, 0, :nx] + alphas[None, :, None] \
            * dz_loc[:, None, 0, :nx]
        x0_res = torch.where(on_first[:, None],
                             torch.sum(torch.abs(cand_x0 - xs), dim=-1), zero)
        return mesh.psum(cost_tot + mu * (defect_tot + x0_res))

    rho = _kernels.scalar(rho, dev, dtype)
    drho = torch.ones((), dtype=dtype, device=dev)
    merit = torch.full((), float("inf"), dtype=dtype, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    gave_up_any = torch.zeros((), dtype=torch.bool, device=dev)
    pcg_iters = torch.full((max_iter,), -1, dtype=torch.int32, device=dev)
    pcg_converged = torch.zeros((max_iter,), dtype=torch.bool, device=dev)
    ls_alpha_idx = torch.full((max_iter,), -1, dtype=torch.int32, device=dev)

    it = 0
    while it < iter_bound and (it == 0 or not bool(stop)):
        if fused:
            lane = build_fused(xu_loc, rho)
            S, Pinv, gamma = lane["S"], lane["Pinv"], lane["gamma"]
        else:
            A, B, Q, q, R, r, c = build_blocks(xu_loc)
            S, Pinv, gamma, Qinv, Rinv = form_schur(A, B, Q, q, R, r, c, rho)
        lam_new, lin_iters, lin_ok = solve_lin(
            S, Pinv, gamma, lam_loc, pcg_cfg.max_iter, tol, mesh,
            pcg_cfg.exit_criterion)
        if fused:
            dz = dz_fused(lane, xu_loc, lam_new, rho)
            merits = merits_fused(xu_loc, dz)
        else:
            dz = compute_dz(A, B, q, r, Qinv, Rinv, lam_new)
            merits = merits_of(xu_loc, dz)

        step = line_search_update(merits[0], alphas, rho, drho, sqp_cfg)
        xu_loc = torch.where(step.success, xu_loc + step.alpha * dz, xu_loc)
        lam_loc = lam_new
        rho, drho, merit, stop = step.rho, step.drho, step.merit, step.stop
        gave_up_any = gave_up_any | stop
        pcg_iters[it] = lin_iters[0]
        pcg_converged[it] = lin_ok[0]
        ls_alpha_idx[it] = step.alpha_idx
        it += 1

    return SQPResult(
        xu=mesh.gather(xu_loc), lam=mesh.gather(lam_loc), rho=rho, drho=drho,
        sqp_iters=torch.full((), it, dtype=torch.int32, device=dev),
        merit=merit, gave_up=gave_up_any, pcg_iters=pcg_iters,
        pcg_converged=pcg_converged, ls_alpha_idx=ls_alpha_idx)


def make_sharded_sqp_solver(model: RobotModel, cost: CostConfig,
                            sqp_cfg: SQPConfig, pcg_cfg: PCGConfig, dt: float,
                            mesh, integrator_type: int = 0,
                            fused: bool | str = "auto",
                            pcg_method: str = "auto", pcg_s_steps: int = 4):
    """A solver fn(xu, lam, xs, ee_goal, rho[, iter_budget]) -> SQPResult
    over ``mesh`` with the model, configuration and route bound."""

    def solve(xu, lam, xs, ee_goal, rho, iter_budget=None):
        return sqp_solve_sharded(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs,
                                 ee_goal, rho, dt, mesh,
                                 integrator_type=integrator_type,
                                 iter_budget=iter_budget, fused=fused,
                                 pcg_method=pcg_method, pcg_s_steps=pcg_s_steps)

    return solve
