"""The port's SQP solves over the shared loop (``solver/sqp.py``: one
state, one loop, one result) against copies of the loops they had before
it: the fleet's ``sqp_solve_batched_fused`` and the knot shards'
``sqp_solve_sharded`` bit for bit (as ``test_torch_sqp_graph.py`` holds the
one-arm ``sqp_solve`` to its loop before), and the ATen operations one SQP
iteration dispatches outside the kernel wrappers, held to the counts those
loops dispatched.  On the CPU the wrappers run their plain versions; no
JAX."""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.ops.pcg_cuda import compute_dz_slab
from mpcgpu_tpu_torch.ops.pcg_slab import block_mv as _mv
from mpcgpu_tpu_torch.ops.smallmat import gj_inverse
from mpcgpu_tpu_torch.parallel import KnotMesh, batched_cuda, sqp_sharded
from mpcgpu_tpu_torch.parallel.batched_cuda import (
    build_kkt_schur_batched, compute_dz_batched, line_search_merits_batched,
    line_search_merits_batched_plain, pcg_solve_batched)
from mpcgpu_tpu_torch.parallel.pcg_sharded import local_pcg
from mpcgpu_tpu_torch.parallel.sqp_sharded import (H, _mtv, _next, _prev,
                                                   _resolve_route)
from mpcgpu_tpu_torch.solver import sqp, sqp_graph
from mpcgpu_tpu_torch.solver.kkt import (euler_step_and_jacobians,
                                         integrator_step,
                                         tracking_cost_grad_hess)
from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur_slab
from mpcgpu_tpu_torch.solver.merit import line_search_alphas, tracking_cost
from mpcgpu_tpu_torch.solver.merit_cuda import line_search_merit_partials_slab
from mpcgpu_tpu_torch.solver.sqp import SQPResult, line_search_update
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N, DT = 8, 1.0 / 64.0


# ---- the loops as they were --------------------------------------------------

def _fleet_before(model, cost, sqp_cfg, pcg_cfg, xu_b, lam_b, xs_b, ee_b, rho_b,
                  dt, integrator_type=0, angle_wrap=False, merit_impl="auto"):
    """``sqp_solve_batched_fused`` before its loop was shared, spans aside."""
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
        if it and bool(stop.all()):
            break
        sys = build_kkt_schur_batched(model, cost, xu, xs_b, ee_b, rho, dt,
                                      integrator_type, angle_wrap)
        lam_new, lin_iters, lin_ok = pcg_solve_batched(
            sys["S"], sys["Pinv"], sys["gamma"], lam,
            max_iter=pcg_cfg.max_iter, exit_tol=exit_tol,
            exit_criterion=pcg_cfg.exit_criterion)
        dz = compute_dz_batched(sys, lam_new, xu[:, :, nx:], rho, cost.r_cost)
        merits, alphas = merits_of(
            model, cost, xu, dz, xs_b, ee_b, mu, dt,
            num_alphas=sqp_cfg.num_alphas, integrator_type=integrator_type,
            angle_wrap=angle_wrap)

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

    return SQPResult(xu=xu, lam=lam, rho=rho, drho=drho, sqp_iters=sqp_iters,
                     merit=merit, gave_up=gave_up_any, pcg_iters=pcg_iters,
                     pcg_converged=pcg_converged, ls_alpha_idx=ls_alpha_idx)


def _sharded_before(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_goal, rho, dt,
                    mesh, integrator_type=0, knot_axis="knot", iter_budget=None,
                    fused="auto", pcg_method="auto", pcg_s_steps=4):
    """``sqp_solve_sharded`` before its loop was shared, verbatim."""
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


# ---- the shared loop against them -------------------------------------------

def _inputs(B: int, n: int, dtype, give_up: bool):
    """B noisy copies of trace 0_0's rows 350.. (numpy seed 0): xu, lam0 =
    0, xs, ee; give_up: the last instance's goal NaN, so that its first line
    search fails."""
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[350:350 + n][None] + 0.02 * rng.standard_normal((B, n, 21))
    ee = np.broadcast_to(load_eepos_traj("0_0")[350:350 + n], (B, n, 6)).copy()
    if give_up:
        ee[-1] = np.nan
    t = lambda a: torch.tensor(a, dtype=dtype)
    return t(xu), torch.zeros((B, n, 14), dtype=dtype), t(xu[:, 0, :14]), t(ee)


def _bits(x):
    """x's bits: a float tensor viewed as integers of its width, so that two
    NaNs compare by their bits too."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("max_iter", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_the_fleet_equals_its_loop_before(dtype, max_iter):
    """Three instances, the last of which gives up at once (a NaN goal and
    rho 5e-3 over a rho_max of 4e-3) and stays frozen while the others go
    on: bit for bit the loop before, over a chain of two solves, the second
    from the first's result."""
    model, cost = iiwa14(dtype, device="cpu"), CostConfig.for_knots(N)
    sqp_cfg = SQPConfig(max_iter=max_iter, rho_max=4e-3)
    pcg_cfg = PCGConfig(max_iter=30, exit_tol=1e-6)
    xu, lam, xs, ee = _inputs(3, N, dtype, give_up=True)
    a = b = SQPResult(xu, lam, *(None,) * 8)
    rho = torch.tensor([1e-3, 2e-3, 5e-3], dtype=dtype)
    for _ in range(2):
        a = batched_cuda.sqp_solve_batched_fused(model, cost, sqp_cfg, pcg_cfg, a.xu,
                                                 a.lam, xs, ee, rho, DT)
        b = _fleet_before(model, cost, sqp_cfg, pcg_cfg, b.xu, b.lam, xs, ee, rho, DT)
        assert _same(a, b)
    assert a.gave_up.tolist() == [False, False, True]
    assert int(a.sqp_iters[-1]) == 1 and bool((a.pcg_iters[-1, 1:] == -1).all())


# name -> (solve keywords, SQP settings, dtype, the last goal NaN)
SHARDED_CASES = {
    "unfused": (dict(fused=False), dict(max_iter=3), torch.float64, False),
    "unfused-f32": (dict(fused=False), dict(max_iter=3), torch.float32, False),
    "unfused-one-iteration": (dict(fused=False), dict(max_iter=1), torch.float64,
                              False),
    "unfused-budget": (dict(fused=False, iter_budget=2), dict(max_iter=3),
                       torch.float64, False),
    "fused": (dict(fused=True), dict(max_iter=3), torch.float64, False),
    "fused-f32-budget": (dict(fused=True, iter_budget=2), dict(max_iter=3),
                         torch.float32, False),
    "gives-up": (dict(fused=False), dict(max_iter=3, rho_max=4e-3), torch.float64,
                 True),
}


@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_the_knot_shards_equal_their_loop_before(case):
    """sqp_solve_sharded over two knot shards (the fused route: the slab
    kernels' plain versions) bit for bit the loop before; ``gives-up``: a
    NaN goal and rho 5e-3 over a rho_max of 4e-3 stop the loop after one
    iteration."""
    kw, sqp_kw, dtype, nan_goal = SHARDED_CASES[case]
    n = 16
    model, cost = iiwa14(dtype, device="cpu"), CostConfig.for_knots(n)
    sqp_cfg, pcg_cfg = SQPConfig(**sqp_kw), PCGConfig(max_iter=30, exit_tol=1e-6)
    xu, lam, xs, ee = (t[0] for t in _inputs(1, n, dtype, nan_goal))
    rho = 5e-3 if nan_goal else 1e-3
    args = (model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee, rho, DT, KnotMesh(2))
    got = sqp_sharded.sqp_solve_sharded(*args, **kw)
    assert _same(got, _sharded_before(*args, **kw))
    assert int(got.sqp_iters) == (1 if nan_goal else min(sqp_cfg.max_iter,
                                                         kw.get("iter_budget", 9)))


# ---- ATen operations an SQP iteration dispatches ----------------------------

class _Ops(TorchDispatchMode):
    """Counts the ATen operations dispatched while it is on, except inside
    the calls it is paused for (``_outside``)."""

    def __init__(self):
        super().__init__()
        self.n, self.paused = 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not self.paused
        return func(*args, **(kwargs or {}))


def _outside(monkeypatch, ops: _Ops, module, names) -> None:
    """The module's functions ``names`` (kernel wrappers) run uncounted."""
    for name in names:
        fn = getattr(module, name)

        @functools.wraps(fn)     # with its .launches, which a launch advances
        def paused(*a, _fn=fn, **k):
            ops.paused += 1
            try:
                return _fn(*a, **k)
            finally:
                ops.paused -= 1
        monkeypatch.setattr(module, name, paused)


ARM_WRAPPERS = ("build_kkt_schur", "pcg_dz_solve", "pcg_solve_cuda_uncast",
                "compute_dz_cuda", "line_search_merits_fused")
FLEET_WRAPPERS = ("build_kkt_schur_batched", "pcg_solve_batched",
                  "compute_dz_batched", "line_search_merits_batched")

# what the loops dispatched before they were shared, counted on the CPU by
# the functions below: one fleet iteration and its stop read, and the rest
# of a one-iteration fleet solve (B = 3); one arm iteration eagerly and its
# stop read; sqp._iteration and the graph's step (what its capture records)
# on K2 and on K2' -> K6
BEFORE = {"fleet iteration": 65, "fleet solve of one iteration": 72,
          "arm iteration": 42, "_iteration k2": 41, "step k2": 51,
          "_iteration k2-split": 41, "step k2-split": 51}


def _fleet_ops(monkeypatch, max_iter: int) -> int:
    ops = _Ops()
    _outside(monkeypatch, ops, batched_cuda, FLEET_WRAPPERS)
    model, cost = iiwa14(torch.float32, device="cpu"), CostConfig.for_knots(N)
    xu, lam, xs, ee = _inputs(3, N, torch.float32, give_up=False)
    rho = torch.full((3,), 1e-3)
    with ops:
        res = batched_cuda.sqp_solve_batched_fused(
            model, cost, SQPConfig(max_iter=max_iter), PCGConfig(max_iter=30), xu,
            lam, xs, ee, rho, DT, merit_impl="cuda")
    assert res.sqp_iters.tolist() == [max_iter] * 3
    return ops.n


def _arm_ops(monkeypatch, max_iter: int) -> int:
    ops = _Ops()
    _outside(monkeypatch, ops, sqp, ARM_WRAPPERS)
    model, cost = iiwa14(torch.float32, device="cpu"), CostConfig.for_knots(N)
    xu, lam, xs, ee = (t[0] for t in _inputs(1, N, torch.float32, give_up=False))
    with ops:
        res = sqp.sqp_solve(model, cost, SQPConfig(max_iter=max_iter),
                            PCGConfig(max_iter=30), xu, lam, xs, ee, 1e-3, DT,
                            linsys="pcg_cuda", merit_impl="cuda")
    assert int(res.sqp_iters) == max_iter
    return ops.n


def _graph_ops(monkeypatch, fused_dz: bool) -> tuple:
    """(sqp._iteration, the graph's step) on a graph entry's buffer."""
    ops = _Ops()
    _outside(monkeypatch, ops, sqp, ARM_WRAPPERS)
    model, cost = iiwa14(torch.float32, device="cpu"), CostConfig.for_knots(N)
    xu, lam, xs, ee = (t[0] for t in _inputs(1, N, torch.float32, give_up=False))
    sqp_cfg, pcg_cfg = SQPConfig(max_iter=2), PCGConfig(max_iter=30)
    g = sqp_graph.iteration_graph(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee,
                                  DT, 2, 0, False, fused_dz)
    g.load(xu, lam, xs, ee, 1e-3, 1.0)
    with ops:
        sqp._iteration(g.route, g.state, g.v["it"])
    n = ops.n
    with ops:
        g.step()
    sqp_graph.clear()
    return n, ops.n - n


def test_a_fleet_iteration_dispatches_no_more_than_before(monkeypatch):
    one, two = _fleet_ops(monkeypatch, 1), _fleet_ops(monkeypatch, 2)
    got = {"fleet iteration": two - one, "fleet solve of one iteration": one}
    assert all(got[k] <= BEFORE[k] for k in got), (got, BEFORE)


@pytest.mark.parametrize("fused_dz", [True, False], ids=["k2", "k2-split"])
def test_an_arm_iteration_dispatches_no_more_than_before(monkeypatch, fused_dz):
    route = "k2" if fused_dz else "k2-split"
    n_iter, n_step = _graph_ops(monkeypatch, fused_dz)
    got = {f"_iteration {route}": n_iter, f"step {route}": n_step}
    if fused_dz:
        got["arm iteration"] = _arm_ops(monkeypatch, 2) - _arm_ops(monkeypatch, 1)
    assert all(got[k] <= BEFORE[k] for k in got), (got, BEFORE)
