"""K8: the batched SQP solve with the instance as a grid axis.

Port of ``mpcgpu_tpu/parallel/batched_fused.py``.  On the TPU that module
packs several instances along the 128 lanes of a vreg
(``instances_per_program``, ``pack_lanes``, ``unpack_lanes``) and runs a
Pallas grid over instance groups, with segmented reductions that give each
packed instance its own CG scalars.  On a GPU the instance is simply one
more grid axis of the single-instance kernels, so the packing has no
counterpart here and every tensor keeps the (B, N, ...) layout:

  * K8a ``build_kkt_schur_batched``: K1's kernel over a (window, instance)
    grid with a per-instance rho and, where the batch fills the card, long
    windows whose knot groups take the slots in turn
    (``solver/kkt_cuda.py::kkt_batched_plan``; replaces
    batched_fused.py:150);
  * K8b ``pcg_solve_batched``: K2' with one cluster per instance, each with
    its own CG scalars and its own exit, so every instance's iterations and
    exit flag are exact (replaces batched_fused.py:335);
  * K8c ``compute_dz_batched``: K6's kernel over (CTA, instance) with a
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
is active and ``it < max_iter``.  Its iteration is ``_batched_iteration``;
its state, loop and result are ``solver/sqp.py``'s (``_initial_state``,
``_loop``, ``_result``).  With the batched K3 merits on a card
(``sqp.graph_engages``) each iteration is one replay of a CUDA graph of
``_batched_iteration`` (``solver/sqp_graph.py``, keyed by ``_graph_key``),
as the one-arm solve's; CPU tensors and the plain merits run it eagerly,
with the same results.  ``sqp_solve_batched_fused_sharded`` runs it
on each instance group of an (instance, knot) mesh (``parallel/mesh.py``).
Under a ``torch.profiler`` session it records the spans and counters that
``solver/sqp.py::sqp_solve`` records (``utils/profiling.py``; on the graph
path ``sqp.solve``, ``sqp.stop_read`` and ``sqp.replay``), with the batch
size on each span and frozen instances left out of the counters, and per
K8a launch its knot stages and knots (``k8a.knot_stages``, ``k8a.knots``).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.ops.pcg import pcg_solve
from mpcgpu_tpu_torch.ops.pcg_cuda import (_check_pcg_args, compute_dz_plain,
                                           dz_plan, k2_cluster_plan,
                                           require_dz_alignment, require_nx)
from mpcgpu_tpu_torch.solver.kkt_cuda import (_check_args, build_kkt_schur_plain,
                                              kkt_batched_plan, kkt_knot_stages,
                                              kkt_window_occupancy)
from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merits_plain,
                                                merit_span_scratch,
                                                merit_team_plan)
from mpcgpu_tpu_torch.solver import sqp, sqp_graph
from mpcgpu_tpu_torch.solver.sqp import (SQPResult, _at, _initial_state, _loop,
                                         _record, _result, _State,
                                         line_search_update)
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


_K8A_PLANS: dict = {}
_K8A_OCCUPANCY: dict = {}


def k8a_plan(N: int, B: int, nq: int, device):
    """K8a's plan (``kkt_batched_plan``) for the card ``device``: its SM
    count and the CTAs an SM of the kernel built for nq holds, as the card
    reports them; cached per card and shape."""
    key = (device.index, N, B, nq)
    plan = _K8A_PLANS.get(key)
    if plan is None:
        def ctas_per_sm(groups, smem):
            k = (device.index, nq, groups, smem)
            if k not in _K8A_OCCUPANCY:
                _K8A_OCCUPANCY[k] = kkt_window_occupancy(groups, smem, nq, device)[2]
            return _K8A_OCCUPANCY[k]

        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = _K8A_PLANS[key] = kkt_batched_plan(N, B, nq, sms, ctas_per_sm)
    return plan


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
    plan = k8a_plan(N, B, nq, dev)
    _kernels.launch(
        dev, "kkt_schur.cu", "kkt_schur_batched_launch", nq,
        xu_b.data_ptr(), xu_b.stride(1), xu_b.stride(0), ee_b.data_ptr(),
        ee_b.stride(1), ee_b.stride(0), rho_b.data_ptr(), float(dt),
        packed.data_ptr(), float(model.gravity), float(cost.qd_cost),
        float(cost.r_cost), N, B, plan.window, plan.groups, plan.smem_bytes,
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
    require_dz_alignment(lam=lam, **{k: sys[k] for k in ("Qinv", "A", "B", "q")})
    dz = torch.empty((B, N, nx + nu), dtype=torch.float32, device=dev)
    _kernels.launch(
        dev, "pcg_dz.cu", "dz_warp_launch", nu,
        lam.data_ptr(), None, None, sys["Qinv"].data_ptr(), sys["A"].data_ptr(),
        sys["B"].data_ptr(), sys["q"].data_ptr(), N, u.data_ptr(), u.stride(1),
        u.stride(0), rho_b.data_ptr(), 1, float(r_cost), N, B, *dz_plan(N, nx),
        dz.data_ptr())
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


# the wrappers the fleet's iteration calls on the card, whose .launches a
# graph replay advances (solver/sqp_graph.py)
WRAPPERS = (build_kkt_schur_batched, pcg_solve_batched, compute_dz_batched,
            line_search_merits_batched)


def _k8a_counts(model: RobotModel, xu_b) -> tuple:
    """The host counts of one K8a launch on xu_b (B, N, ...): (name, n)
    for ``k8a.knot_stages`` (B x the knots its windows linearize) and
    ``k8a.knots`` (B x N); none on CPU tensors (the plain version)."""
    if _kernels.on_cpu(xu_b):
        return ()
    B, N = xu_b.shape[:2]
    window = k8a_plan(N, B, model.nq, xu_b.device).window
    return ("k8a.knot_stages", B * kkt_knot_stages(N, window)), ("k8a.knots", B * N)


class _Route(NamedTuple):
    """What the fleet's SQP iterations read besides the carried state."""
    model: RobotModel
    cost: CostConfig
    sqp_cfg: SQPConfig
    pcg_cfg: PCGConfig
    xs: torch.Tensor
    ee_goal: torch.Tensor
    dt: float
    integrator_type: int
    angle_wrap: bool
    merits: Callable        # the batched K3 or its plain version per instance
    exit_tol: torch.Tensor  # () pcg_cfg.exit_tol, every iteration's


def _batched_iteration(r: _Route, st: _State, it, tr=None) -> _State:
    """One SQP iteration of every instance from ``st`` (``sqp._iteration``'s
    contract over an instance axis): K8a, K8b at the fixed PCG tolerance
    (no Eisenstat-Walker forcing), K8c, the merits, and each instance's
    line-search step and rho.  An instance that gave up earlier is frozen:
    nothing of it changes, its buffer entries included.  Each instance's
    iterations are counted here (``sqp_iters``).  The eager loop runs it
    with ``it`` an int and the solve's recorder ``tr``; ``sqp_graph``
    captures it with ``it`` on the card and no recorder."""
    model, cost, sqp_cfg, pcg_cfg = r.model, r.cost, r.sqp_cfg, r.pcg_cfg
    xu, lam, rho = st.xu, st.lam, st.rho
    nx = 2 * model.nq
    if tr:
        tr.phase("sqp.kkt", it)
    sys = build_kkt_schur_batched(model, cost, xu, r.xs, r.ee_goal, rho, r.dt,
                                  r.integrator_type, r.angle_wrap)
    if tr:
        for name, n in _k8a_counts(model, xu):
            tr.count(name, n)
        tr.phase("sqp.linsys")
    lam_new, lin_iters, lin_ok = pcg_solve_batched(
        sys["S"], sys["Pinv"], sys["gamma"], lam, max_iter=pcg_cfg.max_iter,
        exit_tol=r.exit_tol, exit_criterion=pcg_cfg.exit_criterion)
    if tr:
        tr.phase("sqp.dz")
    dz = compute_dz_batched(sys, lam_new, xu[:, :, nx:], rho, cost.r_cost)
    if tr:
        tr.lam_solved(lam_new)
        tr.phase("sqp.merits")
    merits, alphas = r.merits(
        model, cost, xu, dz, r.xs, r.ee_goal, float(sqp_cfg.mu), r.dt,
        num_alphas=sqp_cfg.num_alphas, integrator_type=r.integrator_type,
        angle_wrap=r.angle_wrap)

    if tr:
        tr.phase("sqp.step")
    step = line_search_update(merits, alphas, rho, st.drho, sqp_cfg)
    # an instance that gave up earlier is frozen: nothing of it changes
    frozen = st.stop
    take = step.success & ~frozen
    kept = lambda buf, v: torch.where(frozen, _at(buf, it), v)
    _record(st, it, kept(st.pcg_iters, lin_iters), kept(st.pcg_converged, lin_ok),
            kept(st.ls_alpha_idx, step.alpha_idx))
    return st._replace(
        xu=torch.where(take[:, None, None], xu + step.alpha[:, None, None] * dz, xu),
        lam=torch.where(frozen[:, None, None], lam, lam_new),
        rho=torch.where(frozen, rho, step.rho),
        drho=torch.where(frozen, st.drho, step.drho),
        merit=torch.where(frozen, st.merit, step.merit),
        stop=frozen | step.stop, gave_up=st.gave_up | step.stop,
        sqp_iters=st.sqp_iters + (~frozen).to(torch.int32))


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
    loop (``sqp._loop`` over ``_batched_iteration``) reads ``all(stop)``
    back to the host once per iteration after the first.  merit_impl picks
    the merits, as ``sqp_solve``'s does: "cuda" the batched K3 (its plain
    version on CPU tensors), "plain" ``line_search_merits(include_zero=True)``
    per instance, "auto" the batched K3 on the card in ee cost mode and the
    plain merits otherwise.  With the batched K3 on a card each SQP
    iteration is one CUDA graph replay (module docstring); every other
    call runs the iterations eagerly.  Both run ``_batched_iteration``,
    with the same results."""
    if pcg_cfg.preconditioner != "stair":
        raise ValueError("the batched kernels implement the stair "
                         "preconditioner only")
    if merit_impl == "auto":
        use_kernel = xu_b.device.type == "cuda" and cost.mode == "ee"
    elif merit_impl in ("cuda", "plain"):
        use_kernel = merit_impl == "cuda"
    else:
        raise ValueError(f"unknown merit_impl {merit_impl!r}")
    if sqp.graph_engages(True, use_kernel, xu_b):
        return _solve_graph(model, cost, sqp_cfg, pcg_cfg, xu_b, lam_b, xs_b,
                            ee_b, rho_b, dt, integrator_type, angle_wrap)
    return _solve_eager(model, cost, sqp_cfg, pcg_cfg, xu_b, lam_b, xs_b, ee_b,
                        rho_b, dt, integrator_type, angle_wrap, use_kernel)


def _solve_eager(model, cost, sqp_cfg, pcg_cfg, xu_b, lam_b, xs_b, ee_b, rho_b,
                 dt, integrator_type: int, angle_wrap: bool,
                 use_kernel: bool) -> SQPResult:
    """``sqp_solve_batched_fused``'s loop with every iteration enqueued by
    the host (the route checked and resolved by the caller)."""
    B = xu_b.shape[0]
    tr = profiling.solve_trace(B)
    dev, dtype = xu_b.device, xu_b.dtype
    exit_tol = _kernels.scalar(pcg_cfg.exit_tol, dev, dtype)
    st = _initial_state(xu_b, lam_b, rho_b.to(device=dev, dtype=dtype),
                        torch.ones((B,), dtype=dtype, device=dev), exit_tol,
                        sqp_cfg.max_iter)
    r = _Route(model, cost, sqp_cfg, pcg_cfg, xs_b, ee_b, dt, integrator_type,
               angle_wrap, line_search_merits_batched if use_kernel
               else line_search_merits_batched_plain, exit_tol)
    st, _ = _loop(functools.partial(_batched_iteration, r), st, sqp_cfg.max_iter,
                  tr)
    result = _result(st)
    if tr:
        tr.finish(result)
    return result


def _graph_key(model, cost, sqp_cfg, pcg_cfg, xu_b, lam_b, xs_b, ee_b, dt,
               integrator_type, angle_wrap) -> tuple:
    """Everything a capture of the fleet's iteration bakes in: the body and
    its merits (the batched K3), the card, the inputs' shapes and dtypes
    (B, N, nq), the model by identity, dt, the integrator, angle_wrap, and
    the cost, SQP (max_iter, the per-iteration buffers' length, among them)
    and PCG settings."""
    return (_batched_iteration, line_search_merits_batched, xu_b.device,
            tuple((tuple(t.shape), t.dtype) for t in (xu_b, lam_b, xs_b, ee_b)),
            id(model), float(dt), int(integrator_type), bool(angle_wrap), cost,
            sqp_cfg, pcg_cfg)


def _iteration_graph(model, cost, sqp_cfg, pcg_cfg, xu_b, lam_b, xs_b, ee_b,
                     dt, integrator_type, angle_wrap) -> sqp_graph.IterationGraph:
    """The fleet's cached graph entry of the call's key (``_graph_key``):
    ``_batched_iteration`` with the batched K3 merits, its per-iteration
    host counts K8a's."""

    def make():
        dev, dtype = xu_b.device, xu_b.dtype
        exit_tol = _kernels.scalar(pcg_cfg.exit_tol, dev, dtype)
        zero = torch.zeros(xu_b.shape[:1], dtype=dtype, device=dev)
        init = _initial_state(xu_b, lam_b, zero, zero, exit_tol, sqp_cfg.max_iter)
        route = _Route(model, cost, sqp_cfg, pcg_cfg, xs_b, ee_b, dt,
                       integrator_type, angle_wrap, line_search_merits_batched,
                       exit_tol)
        return sqp_graph.IterationGraph(_batched_iteration, route, init, WRAPPERS,
                                        _k8a_counts(model, xu_b))

    return sqp_graph.cached(_graph_key(model, cost, sqp_cfg, pcg_cfg, xu_b, lam_b,
                                       xs_b, ee_b, dt, integrator_type, angle_wrap),
                            model, make)


def _solve_graph(model, cost, sqp_cfg, pcg_cfg, xu_b, lam_b, xs_b, ee_b, rho_b,
                 dt, integrator_type: int, angle_wrap: bool) -> SQPResult:
    """``sqp_solve_batched_fused`` on the graph path: the eager loop's
    iterations, stop-flag reads and result, each iteration a replay (or, a
    key's first, run eagerly and then captured); drho starts at 1 for
    every instance."""
    tr = profiling.solve_trace(xu_b.shape[0])
    g = _iteration_graph(model, cost, sqp_cfg, pcg_cfg, xu_b, lam_b, xs_b, ee_b,
                         dt, integrator_type, angle_wrap)
    return g.solve(tr, sqp_cfg.max_iter, xu_b, lam_b, xs_b, ee_b, rho_b, 1.0)


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
