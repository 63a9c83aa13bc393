"""The SQP iteration as a CUDA graph (``solver/sqp_graph.py``).

On the CPU: which calls take the graph path (the route and the device
decide, nothing else), what separates two graphs' keys, the factored
iteration body against the loop as it was before it was factored (a copy
of that loop below), and the graph path's buffer, copies and recording run
eagerly on the CPU against the eager loop.  On a card (marker ``card``,
skipped without one): the graph path against the eager body bit for bit
over a closed loop, results never overwritten, counters, recaptures, and
one-iteration solves.  No JAX.

On the chip: ``python3 -m pytest tests/test_torch_sqp_graph.py -m card -o
addopts="" --noconftest -q`` (no JAX there; the README).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.ops.pcg import pcg_solve
from mpcgpu_tpu_torch.ops.pcg_cuda import (compute_dz_cuda, pcg_dz_solve,
                                           pcg_solve_cuda, pcg_solve_cuda_uncast)
from mpcgpu_tpu_torch.ops.schur import compute_dz, form_schur_system
from mpcgpu_tpu_torch.solver import sqp, sqp_graph
from mpcgpu_tpu_torch.solver.kkt import build_kkt
from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_cuda, build_kkt_schur
from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merits_fused,
                                                line_search_merits_plain)
from mpcgpu_tpu_torch.utils import profiling
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N, DT = 8, 1.0 / 64.0


@pytest.fixture
def card():
    """The first card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m card)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _no_graphs_left():
    yield
    sqp_graph.clear()


def _problem(n: int, dtype=torch.float64, device="cpu", seed: int = 0,
             start: int = 0):
    """Trace 0_0's rows from ``start`` plus 0.02 N(0, 1) (numpy ``seed``):
    xu, lam0 = 0, xs, ee."""
    rng = np.random.default_rng(seed)
    xu = load_xu_traj("0_0")[start:start + n] + 0.02 * rng.standard_normal((n, 21))
    ee = load_eepos_traj("0_0")[start:start + n]
    t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return t(xu), torch.zeros((n, 14), dtype=dtype, device=device), t(xu[0, :14]), t(ee)


# ---- which calls engage the graph ------------------------------------------

# (solve keywords, the cost's mode, on a card) -> whether the graph engages
ENGAGE = {
    "pcg_cuda": (dict(linsys="pcg_cuda"), "ee", True, True),
    "pcg_cuda-split": (dict(linsys="pcg_cuda", fused_dz=False), "ee", True, True),
    "pcg_cuda-merit-cuda": (dict(linsys="pcg_cuda", merit_impl="cuda"), "ee", True, True),
    "pcg-fused": (dict(linsys="pcg", fused=True), "ee", True, True),
    "pcg_cuda-unfused": (dict(linsys="pcg_cuda", fused=False), "ee", True, False),
    "pcg_cuda-merit-plain": (dict(linsys="pcg_cuda", merit_impl="plain"), "ee", True, False),
    "pcg_cuda-joint-cost": (dict(linsys="pcg_cuda"), "joint", True, False),
    "pcg": (dict(linsys="pcg"), "ee", True, False),
    "ldl": (dict(linsys="ldl"), "ee", True, False),
    "pcr": (dict(linsys="pcr"), "ee", True, False),
    "pcr_cuda": (dict(linsys="pcr_cuda"), "ee", True, False),
    "qdldl_host": (dict(linsys="qdldl_host"), "ee", True, False),
    "cpu-pcg_cuda": (dict(linsys="pcg_cuda"), "ee", False, False),
    "cpu-pcg_cuda-merit-cuda": (dict(linsys="pcg_cuda", merit_impl="cuda"), "ee", False, False),
}


@pytest.mark.parametrize("case", list(ENGAGE))
def test_the_route_and_the_device_decide_the_path(case, monkeypatch):
    """sqp_solve runs the graph path exactly on the fused route with the K3
    merits and xu on a card; every other call runs the eager loop.  The
    paths are stubbed, so xu can stand for a card's tensor here."""
    kw, mode, on_card, want = ENGAGE[case]
    taken = []
    monkeypatch.setattr(sqp_graph, "solve", lambda *a, **k: taken.append("graph"))
    monkeypatch.setattr(sqp, "_solve_eager", lambda *a, **k: taken.append("eager"))
    xu = types.SimpleNamespace(device=torch.device("cuda:0" if on_card else "cpu"))
    sqp.sqp_solve(None, CostConfig(mode=mode), SQPConfig(max_iter=2), PCGConfig(),
                  xu, None, None, None, 1e-3, DT, **kw)
    assert taken == ["graph" if want else "eager"]
    use_kernels = kw.get("merit_impl", "auto") == "cuda" or (
        kw.get("merit_impl", "auto") == "auto" and on_card and mode == "ee")
    fused = kw.get("fused", kw["linsys"] == "pcg_cuda")
    assert sqp.graph_engages(fused, use_kernels, xu) == want


# ---- what separates keys -----------------------------------------------------

def _key_args(**change):
    model = change.pop("model", _KEY_MODEL)
    n = change.pop("n", N)
    xu, lam, xs, ee = _problem(n, torch.float32)
    args = dict(model=model, cost=CostConfig.for_knots(N), sqp_cfg=SQPConfig(max_iter=2),
                pcg_cfg=PCGConfig(max_iter=30), xu=xu, lam=lam, xs=xs, ee_goal=ee,
                dt=DT, max_iter=2, integrator_type=0, angle_wrap=False, fused_dz=True)
    args.update(change)
    return args


_KEY_MODEL = iiwa14(torch.float32, device="cpu")

KEY_CHANGES = {
    "model": lambda: dict(model=iiwa14(torch.float32, device="cpu")),
    "dt": lambda: dict(dt=DT / 2),
    "N": lambda: dict(n=N + 4),
    "dtype": lambda: {k: v.double() for k, v in _key_args().items()
                      if k in ("xu", "lam", "xs", "ee_goal")},
    "cost-r_cost": lambda: dict(cost=CostConfig(r_cost=2e-3)),
    "cost-qd_cost": lambda: dict(cost=dataclasses.replace(CostConfig.for_knots(N),
                                                          qd_cost=2e-4)),
    "sqp-rho_factor": lambda: dict(sqp_cfg=SQPConfig(max_iter=2, rho_factor=1.5)),
    "sqp-num_alphas": lambda: dict(sqp_cfg=SQPConfig(max_iter=2, num_alphas=6)),
    "sqp-mu": lambda: dict(sqp_cfg=SQPConfig(max_iter=2, mu=5.0)),
    "pcg-max_iter": lambda: dict(pcg_cfg=PCGConfig(max_iter=31)),
    "pcg-exit_tol": lambda: dict(pcg_cfg=PCGConfig(max_iter=30, exit_tol=1e-6)),
    "pcg-forcing": lambda: dict(pcg_cfg=PCGConfig(max_iter=30, forcing="ew")),
    "pcg-exit_criterion": lambda: dict(pcg_cfg=PCGConfig(max_iter=30,
                                                         exit_criterion="rnorm")),
    "max_iter": lambda: dict(max_iter=3),
    "integrator_type": lambda: dict(integrator_type=1),
    "angle_wrap": lambda: dict(angle_wrap=True),
    "fused_dz": lambda: dict(fused_dz=False),
}


@pytest.mark.parametrize("element", list(KEY_CHANGES))
def test_each_element_of_the_key_separates_keys(element):
    """Changing one thing a capture bakes in gives another key and another
    cached graph; the same call again gives the same entry."""
    base = _key_args()
    other = _key_args(**KEY_CHANGES[element]())
    assert sqp_graph._key(**base) == sqp_graph._key(**_key_args())
    assert sqp_graph._key(**base) != sqp_graph._key(**other)
    g = sqp_graph.iteration_graph(**base)
    assert sqp_graph.iteration_graph(**_key_args()) is g
    assert sqp_graph.iteration_graph(**other) is not g


def test_the_cache_keeps_the_most_recent_graphs():
    """At most MAX_GRAPHS entries; the least recently used goes first."""
    first = sqp_graph.iteration_graph(**_key_args(dt=DT))
    second = sqp_graph.iteration_graph(**_key_args(dt=2 * DT))
    for k in range(sqp_graph.MAX_GRAPHS - 1):
        sqp_graph.iteration_graph(**_key_args(dt=(k + 3) * DT))
        assert sqp_graph.iteration_graph(**_key_args(dt=DT)) is first
    assert len(sqp_graph._GRAPHS) == sqp_graph.MAX_GRAPHS
    assert sqp_graph.iteration_graph(**_key_args(dt=DT)) is first
    assert sqp_graph.iteration_graph(**_key_args(dt=2 * DT)) is not second


# ---- the factored body against the loop as it was ----------------------------

def _loop_before(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_goal, rho, dt,
                 linsys="pcg", max_sqp_iter=None, integrator_type=0, drho0=1.0,
                 angle_wrap=False, iter_budget=None, merit_impl="auto",
                 fused=None, fused_dz=True):
    """``sqp_solve``'s loop before its body was factored out (spans aside)."""
    if merit_impl == "auto":
        use_kernels = xu.device.type == "cuda" and cost.mode == "ee"
    else:
        use_kernels = merit_impl == "cuda"
    if fused is None:
        fused = linsys == "pcg_cuda" and pcg_cfg.preconditioner == "stair"
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
    one_iter = torch.ones((), dtype=torch.int32, device=dev)
    converged = torch.ones((), dtype=torch.bool, device=dev)
    it = 0
    while it < iter_bound:
        if it and bool(stop):
            break
        pcg_kw = dict(max_iter=pcg_cfg.max_iter, exit_tol=lin_tol,
                      exit_criterion=pcg_cfg.exit_criterion)
        if fused:
            sys_ = build_kkt_schur(model, cost, xu, xs, ee_goal, rho, dt,
                                   integrator_type, angle_wrap)
            if fused_dz:
                lam, dz, lin_iters, lin_ok = pcg_dz_solve(
                    sys_, lam, xu[:, nx:], rho, cost.r_cost, **pcg_kw)
            else:
                lam, lin_iters, lin_ok = pcg_solve_cuda_uncast(
                    sys_["S"], sys_["Pinv"], sys_["gamma"], lam, **pcg_kw)
                dz = compute_dz_cuda(sys_, lam, xu[:, nx:], rho, cost.r_cost)
        else:
            make_kkt = build_kkt_cuda if use_kernels else build_kkt
            kkt = make_kkt(model, cost, xu, xs, ee_goal, dt, integrator_type,
                           angle_wrap)
            schur = form_schur_system(kkt, rho, preconditioner=pcg_cfg.preconditioner)
            if linsys in sqp._DIRECT:
                lam = sqp._DIRECT[linsys](schur.S, schur.gamma)
                lin_iters, lin_ok = one_iter, converged
            else:
                solve = pcg_solve_cuda if linsys == "pcg_cuda" else pcg_solve
                lam, lin_iters, lin_ok = solve(schur.S, schur.Pinv, schur.gamma,
                                               lam, **pcg_kw)
            dz = compute_dz(kkt, schur, lam)
        search = line_search_merits_fused if use_kernels else line_search_merits_plain
        merits, alphas = search(model, cost, xu, dz, xs, ee_goal, mu, dt,
                                num_alphas=sqp_cfg.num_alphas,
                                integrator_type=integrator_type, angle_wrap=angle_wrap)
        step = sqp.line_search_update(merits, alphas, rho, drho, sqp_cfg)
        xu = torch.where(step.success, xu + step.alpha * dz, xu)
        rho, drho, merit, stop = step.rho, step.drho, step.merit, step.stop
        gave_up_any = gave_up_any | stop
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
    return sqp.SQPResult(
        xu=xu, lam=lam, rho=rho, drho=drho,
        sqp_iters=torch.full((), it, dtype=torch.int32, device=dev),
        merit=merit, gave_up=gave_up_any, pcg_iters=pcg_iters,
        pcg_converged=pcg_converged, ls_alpha_idx=ls_alpha_idx)


# name -> (solve keywords, SQP settings, PCG settings, dtype)
BODY_CASES = {
    "fused": (dict(linsys="pcg_cuda"), {}, {}, torch.float64),
    "fused-f32": (dict(linsys="pcg_cuda"), {}, {}, torch.float32),
    "split": (dict(linsys="pcg_cuda", fused_dz=False), {}, {}, torch.float64),
    "fused-ew": (dict(linsys="pcg_cuda"), {}, dict(forcing="ew"), torch.float64),
    "fused-rnorm-budget": (dict(linsys="pcg_cuda", iter_budget=2), dict(max_iter=4),
                           dict(exit_criterion="rnorm"), torch.float64),
    "fused-gives-up": (dict(linsys="pcg_cuda", drho0=50.0), dict(rho_max=4e-3), {},
                       torch.float64),
    "fused-merit-cuda": (dict(linsys="pcg_cuda", merit_impl="cuda"), {}, {},
                         torch.float64),
    "fused-wrap-euler": (dict(linsys="pcg_cuda", angle_wrap=True, integrator_type=1),
                         {}, {}, torch.float64),
    "pcg": (dict(linsys="pcg"), {}, {}, torch.float64),
    "pcg-jacobi": (dict(linsys="pcg"), {}, dict(preconditioner="jacobi"), torch.float64),
    "pcg_cuda-unfused": (dict(linsys="pcg_cuda", fused=False), {}, {}, torch.float64),
    "ldl": (dict(linsys="ldl"), {}, {}, torch.float64),
    "pcr": (dict(linsys="pcr"), {}, {}, torch.float64),
    "pcr_cuda": (dict(linsys="pcr_cuda"), {}, {}, torch.float64),
    "one-iteration": (dict(linsys="pcg_cuda", max_sqp_iter=1), {}, {}, torch.float64),
}


def _same(a, b) -> bool:
    return all(torch.equal(x, y) and x.dtype == y.dtype and x.shape == y.shape
               for x, y in zip(a, b))


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_the_factored_body_equals_the_loop_before(case):
    """sqp_solve on the CPU (the eager loop over ``_iteration``) equals the
    loop as it was before, bit for bit, over a chain of three solves each
    fed the last one's result."""
    kw, sqp_kw, pcg_kw, dtype = BODY_CASES[case]
    model = iiwa14(dtype, device="cpu")
    cost = CostConfig.for_knots(N)
    sqp_cfg = SQPConfig(**{"max_iter": 3, **sqp_kw})
    pcg_cfg = PCGConfig(**{"max_iter": 30, "exit_tol": 1e-6, **pcg_kw})
    xu, lam, xs, ee = _problem(N, dtype)
    a = b = types.SimpleNamespace(xu=xu, lam=lam, rho=1e-3)
    for _ in range(3):
        a = sqp.sqp_solve(model, cost, sqp_cfg, pcg_cfg, a.xu, a.lam, xs, ee, a.rho,
                          DT, **kw)
        b = _loop_before(model, cost, sqp_cfg, pcg_cfg, b.xu, b.lam, xs, ee, b.rho,
                         DT, **kw)
        assert _same(a, b), case


# ---- the graph path's buffer and copies, run eagerly on the CPU --------------

def _graph_solve(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee, rho, drho0=1.0,
                 iter_budget=None, max_sqp_iter=None, fused_dz=True):
    max_iter = sqp_cfg.max_iter if max_sqp_iter is None else max_sqp_iter
    bound = max_iter if iter_budget is None else min(max_iter, iter_budget)
    return sqp_graph.solve(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee, rho, DT,
                           max_iter, bound, 0, drho0, False, fused_dz)


# name -> (keywords of both paths, SQP settings, PCG settings)
PLUMBING_CASES = {
    "k2": (dict(), {}, {}),
    "k2-split": (dict(fused_dz=False), {}, {}),
    "ew": (dict(), {}, dict(forcing="ew")),
    "budget-1-of-3": (dict(iter_budget=1), dict(max_iter=3), {}),
    "budget-0": (dict(iter_budget=0), {}, {}),
    "one-iteration": (dict(max_sqp_iter=1), {}, {}),
    "no-iterations": (dict(max_sqp_iter=0), {}, {}),
    "gives-up": (dict(drho0=50.0), dict(rho_max=4e-3), {}),
}


@pytest.mark.parametrize("case", list(PLUMBING_CASES))
def test_the_graph_path_on_the_cpu_equals_the_eager_loop(case):
    """sqp_graph.solve with CPU tensors (no capture: every iteration runs
    the buffer's step eagerly) equals sqp_solve's eager loop bit for bit
    over a chain of four solves, the plan shifted by a knot between them,
    rho and drho fed back as tensors; no result changes after later
    solves."""
    kw, sqp_kw, pcg_kw = PLUMBING_CASES[case]
    model = iiwa14(torch.float32, device="cpu")
    cost = CostConfig.for_knots(N)
    sqp_cfg = SQPConfig(**{"max_iter": 2, **sqp_kw})
    pcg_cfg = PCGConfig(**{"max_iter": 30, **pcg_kw})
    xu, lam, xs, ee = _problem(N, torch.float32)
    kw = dict(kw)
    drho0 = kw.pop("drho0", 1.0)
    a = b = types.SimpleNamespace(xu=xu, lam=lam, rho=1e-3, drho=drho0)
    kept = []
    for k in range(4):
        a = sqp.sqp_solve(model, cost, sqp_cfg, pcg_cfg, a.xu, a.lam, xs, ee, a.rho,
                          DT, linsys="pcg_cuda", drho0=a.drho, **kw)
        b = _graph_solve(model, cost, sqp_cfg, pcg_cfg, b.xu, b.lam, xs, ee, b.rho,
                         b.drho, **kw)
        assert _same(a, b), (case, k)
        kept.append((b, [t.clone() for t in b]))
        shift = lambda r: r._replace(xu=torch.cat([r.xu[1:], r.xu[-1:]]),
                                     lam=torch.cat([r.lam[1:], r.lam[-1:]]))
        a, b = shift(a), shift(b)
    assert all(_same(res, copy) for res, copy in kept)
    assert len(sqp_graph._GRAPHS) == 1


def test_results_are_fresh_copies():
    """A result's fields are views of two fresh copies of the buffer, the
    plan (xu, lam) and the rest, which the entry never writes again; the
    rest's copy holds no plan."""
    model = iiwa14(torch.float32, device="cpu")
    xu, lam, xs, ee = _problem(N, torch.float32)
    cfgs = (CostConfig.for_knots(N), SQPConfig(max_iter=2), PCGConfig(max_iter=30))
    a = _graph_solve(model, *cfgs, xu, lam, xs, ee, 1e-3)
    b = _graph_solve(model, *cfgs, xu, lam, xs, ee, 1e-3)
    (g,) = sqp_graph._GRAPHS.values()
    storage = lambda t: t.untyped_storage().data_ptr()
    plan = {storage(a.xu), storage(a.lam)}
    rest = {storage(t) for f, t in zip(a._fields, a) if f not in ("xu", "lam")}
    assert len(plan) == len(rest) == 1 and plan != rest
    assert (plan | rest).isdisjoint({storage(t) for t in b} | {storage(g.flat.buf)})
    small = a.rho.untyped_storage().nbytes()
    assert small < xu.numel() * xu.element_size()
    assert a.xu.is_contiguous() and a.lam.is_contiguous()


@pytest.mark.parametrize("replayed", [False, True], ids=["eager-steps", "replays"])
def test_graph_path_recording(replayed, monkeypatch, tmp_path):
    """Under a profiler session the graph path records sqp.solve, one
    sqp.stop_read per later iteration and (replays) one sqp.replay per
    iteration, no phase of the eager loop, counters equal to the eager
    loop's, sqp.replays one per replayed iteration and no capture on the
    CPU; its kept lams are copies.  ``replays``: a stand-in graph whose
    replay runs the buffer's step."""
    model = iiwa14(torch.float32, device="cpu")
    cfgs = (CostConfig.for_knots(N), SQPConfig(max_iter=2), PCGConfig(max_iter=30))
    xu, lam, xs, ee = _problem(N, torch.float32)
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            want = sqp.sqp_solve(model, *cfgs, xu, lam, xs, ee, 1e-3, DT,
                                 linsys="pcg_cuda")
    eager = profiling.counters()
    if replayed:
        g = sqp_graph.iteration_graph(model, *cfgs, xu, lam, xs, ee, DT, 2, 0,
                                      False, True)
        g.graph = object()
        monkeypatch.setattr(sqp_graph.IterationGraph, "replay",
                            lambda self: self.step())
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            got = _graph_solve(model, *cfgs, xu, lam, xs, ee, 1e-3)
    assert _same(want, got)
    names = [s.name for s in profiling.spans()]
    iters = int(want.sqp_iters)
    assert names.count("sqp.solve") == 3
    assert names.count("sqp.stop_read") == 3 * (iters - 1)
    assert names.count("sqp.replay") == (3 * iters if replayed else 0)
    assert not {"sqp.kkt", "sqp.linsys", "sqp.dz", "sqp.merits", "sqp.step"} & set(names)
    counts = profiling.counters()
    assert {k: counts[k] for k in profiling.COUNTER_NAMES} == \
        {k: eager[k] for k in profiling.COUNTER_NAMES}
    assert counts["sqp.replays"] == (3 * iters if replayed else 0)
    assert counts["sqp.captures"] == eager["sqp.captures"] == eager["sqp.replays"] == 0
    (g,) = sqp_graph._GRAPHS.values()
    kept = [lam for *_, lams in profiling._RECORDER.solves for lam in lams]
    assert len(kept) == 3 * iters
    assert all(t.untyped_storage().data_ptr() != g.flat.buf.untyped_storage().data_ptr()
               for t in kept)


def test_fresh_span_scratch_leaves_the_cache_as_it_was():
    """Inside the block merit launches get scratch of their own; after it
    the per-device cache holds what it held before."""
    from mpcgpu_tpu_torch.solver import merit_cuda

    dev = torch.device("cpu")
    before = merit_cuda._SPAN_SCRATCH.get(dev)
    merit_cuda._SPAN_SCRATCH[dev] = held = (torch.zeros(4), torch.zeros(2, dtype=torch.int32))
    try:
        with merit_cuda.fresh_span_scratch(dev):
            assert dev not in merit_cuda._SPAN_SCRATCH
            merit_cuda.merit_span_scratch(dev, 64, 32, 9)
            inner = merit_cuda._SPAN_SCRATCH[dev]
            assert inner[0].numel() == 2 * 64 * 9 and inner is not held
        assert merit_cuda._SPAN_SCRATCH[dev] is held
        with merit_cuda.fresh_span_scratch(torch.device("meta")):
            pass
        assert torch.device("meta") not in merit_cuda._SPAN_SCRATCH
    finally:
        merit_cuda._SPAN_SCRATCH.pop(dev)
        if before is not None:
            merit_cuda._SPAN_SCRATCH[dev] = before


# ---- on the card ------------------------------------------------------------

def _eager(monkeypatch):
    """Every later solve runs the eager loop (the reference)."""
    monkeypatch.setattr(sqp, "graph_engages", lambda *a: False)


def _card_setup(card, n: int = 64):
    model = iiwa14(torch.float32, device=card)
    cost = CostConfig.for_knots(n)
    sqp_cfg = SQPConfig(max_iter=2, max_time_us=None)
    pcg_cfg = PCGConfig(max_iter=PCGConfig.tuned_max_iter(n))
    return model, cost, sqp_cfg, pcg_cfg


@pytest.mark.card
def test_card_closed_loop_bit_for_bit(card, monkeypatch):
    """64 updates of the on-device closed loop (plant, shift, N = 64 from
    trace 0_0's calm row 220): the graph path's every output equals the
    eager body's bit for bit; every SQP iteration after the first capture
    is a replay."""
    from mpcgpu_tpu_torch.config import SimConfig
    from mpcgpu_tpu_torch.sim.mpc import simulate_mpc_ondevice

    model, cost, sqp_cfg, pcg_cfg = _card_setup(card)
    xu_tr, ee_tr = load_xu_traj("0_0")[220:400], load_eepos_traj("0_0")[220:400]
    run = lambda: simulate_mpc_ondevice(
        model, xu_tr, ee_tr, 64, 1 / 64.0, cost=cost, sqp_cfg=sqp_cfg,
        pcg_cfg=pcg_cfg, sim_cfg=SimConfig(max_control_updates=64),
        linsys="pcg_cuda")
    with profiling.trace():
        got = run()
        torch.cuda.synchronize()
    counts = profiling.counters()
    with monkeypatch.context() as m:
        _eager(m)
        want = run()
    for k, v in want.items():
        assert (torch.equal(v, got[k]) if isinstance(v, torch.Tensor)
                else v == got[k]), k
    assert counts["sqp.captures"] <= 1
    assert counts["sqp.replays"] + counts["sqp.captures"] == counts["pcg.solves"]
    assert counts["pcg.solves"] == int((want["pcg_iters"] >= 0).sum())


@pytest.mark.card
def test_card_closed_loop_bit_for_bit_at_n512(card, monkeypatch):
    """The same at the reference's longest tuned horizon: 64 updates at
    N = 512 from trace 3_4's row 0 (calm in rows 0-649), PCG capped at 67,
    where K2 runs its 16-CTA cluster of 32 knots a CTA.  The graph
    captures that non-portable cluster launch and its shared memory, and
    every output equals the eager body's bit for bit."""
    from mpcgpu_tpu_torch.config import SimConfig
    from mpcgpu_tpu_torch.ops.pcg_cuda import k2_cluster_plan
    from mpcgpu_tpu_torch.sim.mpc import simulate_mpc_ondevice

    n = 512
    assert k2_cluster_plan(n)[:2] == (16, 32)
    model, cost, sqp_cfg, pcg_cfg = _card_setup(card, n)
    assert pcg_cfg.max_iter == 67
    xu_tr, ee_tr = load_xu_traj("3_4")[:650], load_eepos_traj("3_4")[:650]
    run = lambda: simulate_mpc_ondevice(
        model, xu_tr, ee_tr, n, 1 / 64.0, cost=cost, sqp_cfg=sqp_cfg,
        pcg_cfg=pcg_cfg, sim_cfg=SimConfig(max_control_updates=64),
        linsys="pcg_cuda")
    with profiling.trace():
        got = run()
        torch.cuda.synchronize()
    counts = profiling.counters()
    with monkeypatch.context() as m:
        _eager(m)
        want = run()
    for k, v in want.items():
        assert (torch.equal(v, got[k]) if isinstance(v, torch.Tensor)
                else v == got[k]), k
    assert counts["sqp.captures"] == 1
    assert counts["sqp.replays"] + 1 == counts["pcg.solves"] \
        == int((want["pcg_iters"] >= 0).sum())


@pytest.mark.card
def test_card_results_survive_later_solves(card):
    """A result equals its copy after later solves from other inputs."""
    model, cost, sqp_cfg, pcg_cfg = _card_setup(card)
    xu, lam, xs, ee = _problem(64, torch.float32, card, start=220)
    solve = sqp.make_sqp_solver(model, cost, sqp_cfg, pcg_cfg, DT, linsys="pcg_cuda")
    first = solve(xu, lam, xs, ee, 1e-3)
    kept = [t.clone() for t in first]
    for seed in (1, 2, 3):
        xu2, _, xs2, ee2 = _problem(64, torch.float32, card, seed=seed, start=230)
        solve(xu2, first.lam, xs2, ee2, first.rho)
    torch.cuda.synchronize()
    assert _same(first, kept)


@pytest.mark.card
@pytest.mark.parametrize("fused_dz", [True, False], ids=["k2", "k2-split"])
def test_card_counters_and_launches_equal_on_both_paths(card, fused_dz, monkeypatch):
    """Over 12 chained solves: the counters and the wrappers' launch counts
    of the graph path equal the eager body's; sqp.replays counts every
    iteration, sqp.captures none (captured before the session)."""
    model, cost, sqp_cfg, pcg_cfg = _card_setup(card)
    xu0, lam0, xs, ee = _problem(64, torch.float32, card, start=220)

    def chain():
        for w in sqp_graph.WRAPPERS:
            w.launches = 0
        r = types.SimpleNamespace(xu=xu0, lam=lam0, rho=1e-3)
        with profiling.trace():
            for _ in range(12):
                r = sqp.sqp_solve(model, cost, sqp_cfg, pcg_cfg, r.xu, r.lam, xs, ee,
                                  r.rho, DT, linsys="pcg_cuda", fused_dz=fused_dz)
            torch.cuda.synchronize()
        return r, profiling.counters(), [w.launches for w in sqp_graph.WRAPPERS]

    sqp.sqp_solve(model, cost, sqp_cfg, pcg_cfg, xu0, lam0, xs, ee, 1e-3, DT,
                  linsys="pcg_cuda", fused_dz=fused_dz)
    got, got_counts, got_launches = chain()
    with monkeypatch.context() as m:
        _eager(m)
        want, want_counts, want_launches = chain()
    assert _same(got, want)
    assert got_launches == want_launches and sum(want_launches) > 0
    assert {k: got_counts[k] for k in profiling.COUNTER_NAMES} == \
        {k: want_counts[k] for k in profiling.COUNTER_NAMES}
    assert got_counts["sqp.replays"] == got_counts["pcg.solves"] > 0
    assert got_counts["sqp.captures"] == 0
    assert want_counts["sqp.replays"] == 0


@pytest.mark.card
@pytest.mark.parametrize("change", ["model", "dt"])
def test_card_a_new_model_or_dt_recaptures(card, change, monkeypatch):
    """A solve with another model object or another dt captures its own
    graph, and its results equal the eager body's."""
    model, cost, sqp_cfg, pcg_cfg = _card_setup(card)
    xu, lam, xs, ee = _problem(64, torch.float32, card, start=220)
    other = dict(model=iiwa14(torch.float32, device=card)) if change == "model" \
        else dict(dt=DT * 0.75)
    runs = []
    for kw in (dict(model=model, dt=DT), dict(dict(model=model, dt=DT), **other)):
        with profiling.trace():
            got = sqp.sqp_solve(kw["model"], cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee,
                                1e-3, kw["dt"], linsys="pcg_cuda")
            torch.cuda.synchronize()
        runs.append(profiling.counters()["sqp.captures"])
        with monkeypatch.context() as m:
            _eager(m)
            want = sqp.sqp_solve(kw["model"], cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee,
                                 1e-3, kw["dt"], linsys="pcg_cuda")
        assert _same(got, want)
    assert runs == [1, 1] and len(sqp_graph._GRAPHS) == 2


@pytest.mark.card
def test_card_one_iteration_solves_and_budgets(card, monkeypatch):
    """One-iteration solves (max_sqp_iter=1, a chain of 8), budgets of 0, 1
    and 2 iterations, and a drho0 tensor: equal to the eager body's."""
    model, cost, sqp_cfg, pcg_cfg = _card_setup(card)
    xu, lam, xs, ee = _problem(64, torch.float32, card, start=220)
    drho = torch.tensor(1.44, device=card)
    calls = [dict(max_sqp_iter=1)] * 8 + [dict(iter_budget=b) for b in (0, 1, 2)] \
        + [dict(drho0=drho)]

    def chain():
        out, r = [], types.SimpleNamespace(xu=xu, lam=lam, rho=1e-3)
        for kw in calls:
            r = sqp.sqp_solve(model, cost, sqp_cfg, pcg_cfg, r.xu, r.lam, xs, ee,
                              r.rho, DT, linsys="pcg_cuda", **kw)
            out.append(r)
        torch.cuda.synchronize()
        return out

    got = chain()
    with monkeypatch.context() as m:
        _eager(m)
        want = chain()
    assert all(_same(a, b) for a, b in zip(got, want))
    assert [int(r.sqp_iters) for r in got[8:11]] == [0, 1, 2]
