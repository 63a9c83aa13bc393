"""The spans and counters of the port's two SQP loops (``utils/profiling.py``):
nothing recorded and nothing changed with no profiler session; under
``profiling.trace()`` one ``sqp.solve`` per call with its phases under it,
the same names on the profiler's timeline, and counters that equal what
the solves' own results give.  On the CPU the kernel wrappers run their
plain versions, so every route runs here; no JAX."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel.batched_cuda import sqp_solve_batched_fused
from mpcgpu_tpu_torch.solver.sqp import sqp_solve
from mpcgpu_tpu_torch.utils import profiling
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N, DT, ITERS = 8, 1.0 / 64.0, 2
PCG = dict(max_iter=30, exit_tol=1e-6)

# route -> (phases of an SQP iteration in order, solve keywords)
ROUTES = {
    "fused": (("sqp.kkt", "sqp.linsys", "sqp.merits", "sqp.step"),
              dict(linsys="pcg_cuda")),
    "split": (("sqp.kkt", "sqp.linsys", "sqp.dz", "sqp.merits", "sqp.step"),
              dict(linsys="pcg_cuda", fused_dz=False)),
    "pcg": (("sqp.kkt", "sqp.linsys", "sqp.dz", "sqp.merits", "sqp.step"),
            dict(linsys="pcg")),
    "ldl": (("sqp.kkt", "sqp.linsys", "sqp.dz", "sqp.merits", "sqp.step"),
            dict(linsys="ldl")),
    "batched": (("sqp.kkt", "sqp.linsys", "sqp.dz", "sqp.merits", "sqp.step"),
                None),
}


def _inputs(B: int, give_up: bool = False, nan_lam0: bool = False):
    """B noisy copies of trace 0_0's first N rows (numpy seed 0), f64;
    give_up: the last instance's goal NaN; nan_lam0: a NaN in its lam0."""
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[:N][None] + 0.02 * rng.standard_normal((B, N, 21))
    ee = np.broadcast_to(load_eepos_traj("0_0")[:N], (B, N, 6)).copy()
    lam = np.zeros((B, N, 14))
    if give_up:
        ee[-1] = np.nan
    if nan_lam0:
        lam[-1, 3, 5] = np.nan
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    return t(xu), t(lam), t(xu[:, 0, :14]), t(ee)


def _solve(route: str, give_up: bool = False, nan_lam0: bool = False):
    """One call of the route's solve.  The batch's give_up: instance 1's
    goal is NaN, so its line search fails at once, and it starts at rho
    5e-3 over a rho_max of 4e-3, so that failure (iteration 0) freezes it
    while instance 0 goes on."""
    model, cost = iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N)
    sqp = SQPConfig(max_iter=ITERS, rho_max=4e-3 if give_up else 10.0)
    if route == "batched":
        xu, lam, xs, ee = _inputs(2, give_up, nan_lam0)
        rho = torch.tensor([1e-3, 5e-3 if give_up else 2e-3], dtype=torch.float64)
        return sqp_solve_batched_fused(model, cost, sqp, PCGConfig(**PCG), xu, lam,
                                       xs, ee, rho, DT)
    xu, lam, xs, ee = (t[0] for t in _inputs(1, give_up, nan_lam0))
    return sqp_solve(model, cost, sqp, PCGConfig(**PCG), xu, lam, xs, ee, 1e-3,
                     DT, **ROUTES[route][1])


_RUNS = {}


def _run(route: str, tmp_path_factory, **case):
    """The route's solve with no profiler session (what the recorder then
    holds) and under ``profiling.trace()`` (the recorder, and the span
    events of the session's Chrome trace in the order they began),
    computed once per module."""
    key = (route, tuple(sorted(case.items())))
    if key not in _RUNS:
        profiling.reset()
        off = _solve(route, **case)
        recorded_off = (profiling.spans(), profiling.counters())
        with profiling.trace(str(tmp_path_factory.mktemp("trace"))) as prof:
            on = _solve(route, **case)
        events = json.loads(Path(prof.trace_path).read_text())["traceEvents"]
        events = sorted((e for e in events if e.get("ph") == "X"
                         and e.get("name") in profiling.SPAN_NAMES),
                        key=lambda e: (float(e["ts"]), -float(e["dur"])))
        _RUNS[key] = dict(off=off, recorded_off=recorded_off, on=on,
                          spans=profiling.spans(), counters=profiling.counters(),
                          events=events)
    return _RUNS[key]


def test_recording_follows_the_profiler_session():
    """On exactly while a torch.profiler session is active, trace() or any
    other; trace() clears what an earlier session recorded."""
    assert profiling.solve_trace(1) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tr = profiling.solve_trace(4)
        assert tr is not None
        tr.finish(_solve_result_stub())
    assert profiling.solve_trace(1) is None
    assert [s.name for s in profiling.spans()] == ["sqp.solve"]
    assert profiling.spans()[0].batch == 4
    with profiling.trace():
        assert profiling.spans() == []
        assert profiling.solve_trace(1) is not None
    profiling.reset()
    assert profiling.spans() == [] and set(profiling.counters().values()) == {0}


def _solve_result_stub():
    empty = torch.zeros(0, dtype=torch.int32)
    return type("Result", (), dict(pcg_iters=empty, pcg_converged=empty.bool(),
                                   ls_alpha_idx=empty))


@pytest.mark.parametrize("route", list(ROUTES))
def test_recording_off_records_nothing_and_changes_nothing(route, tmp_path_factory):
    """With no profiler session the solve records nothing; under one its
    result is bit for bit the same."""
    run = _run(route, tmp_path_factory)
    spans, counts = run["recorded_off"]
    assert spans == [] and set(counts.values()) == {0}
    for field in run["off"]._fields:
        assert torch.equal(getattr(run["off"], field), getattr(run["on"], field)), field


@pytest.mark.parametrize("route", list(ROUTES))
def test_spans_under_trace(route, tmp_path_factory):
    """One sqp.solve; per SQP iteration one of each of the route's phases,
    in order, under the solve and within it; k - 1 stop-flag reads for the
    k iterations the cap ends; the session's Chrome trace holds the same
    names in the same order, each event as long as its span to within
    50 us."""
    run = _run(route, tmp_path_factory)
    phases, spans = ROUTES[route][0], run["spans"]
    k = int(run["on"].sqp_iters.max())
    assert k == ITERS
    solve = spans[0]
    assert solve.name == "sqp.solve" and solve.parent is None
    assert solve.batch == (2 if route == "batched" else 1)
    want = []
    for i in range(k):
        want += [(name, i) for name in phases]
        if i < k - 1:
            want.append(("sqp.stop_read", i))
    assert [(s.name, s.iteration) for s in spans[1:]] == want
    for s in spans[1:]:
        assert s.parent == 0 and s.solve == solve.solve and s.batch == solve.batch
        assert solve.start_ns <= s.start_ns <= s.end_ns <= solve.end_ns
    for a, b in zip(spans[1:], spans[2:]):
        assert a.end_ns <= b.start_ns
    assert [e["name"] for e in run["events"]] == [s.name for s in spans]
    # a range's entry and the clock read beside it are two statements, and
    # on a loaded machine the thread can lose the processor between them:
    # such a run is traced again, up to twice
    for attempt in range(3):
        off = [abs(float(e["dur"]) - (s.end_ns - s.start_ns) / 1e3)
               for e, s in zip(run["events"], spans)]
        if max(off) < 50:
            break
        del _RUNS[(route, ())]
        run = _run(route, tmp_path_factory)
        spans = run["spans"]
        assert [e["name"] for e in run["events"]] == [s.name for s in spans]
    assert max(off) < 50, off


CASES = [(route, {}) for route in ROUTES] + [
    ("batched", dict(give_up=True)), ("pcg", dict(nan_lam0=True)),
    ("batched", dict(nan_lam0=True))]


@pytest.mark.parametrize("route, case", CASES,
                         ids=[f"{r}-{'-'.join(c) or 'plain'}" for r, c in CASES])
def test_counters_equal_the_results(route, case, tmp_path_factory):
    """Each counter against the result's own fields: every SQP iteration
    an instance ran (pcg_iters >= 0, frozen ones left out) is one linear
    solve and one line search; cap exits are its ~pcg_converged, rejections
    its ls_alpha_idx == -1; a NaN planted in lam0 (or a goal) shows as a
    non-finite solve."""
    run = _run(route, tmp_path_factory, **case)
    res, got = run["on"], run["counters"]
    ran = res.pcg_iters >= 0
    assert got["pcg.solves"] == got["ls.searches"] == int(ran.sum()) \
        == int(res.sqp_iters.sum())
    assert got["pcg.cap_exits"] == int((ran & ~res.pcg_converged).sum())
    assert got["ls.rejects"] == int((ran & (res.ls_alpha_idx == -1)).sum())
    if case.get("give_up"):
        # frozen after iteration 0, whose NaN lam alone counts
        assert res.sqp_iters.tolist() == [ITERS, 1]
        assert res.pcg_iters[1, 1:].tolist() == [-1] * (ITERS - 1)
        assert got["pcg.solves"] == ITERS + 1 and got["pcg.nonfinite"] == 1
    else:
        assert (got["pcg.nonfinite"] > 0) == bool(case.get("nan_lam0"))
    if route == "ldl":   # a direct solve: one iteration that converged
        assert got["pcg.cap_exits"] == 0


@pytest.mark.parametrize("route, case", CASES,
                         ids=[f"{r}-{'-'.join(c) or 'plain'}" for r, c in CASES])
def test_halvings_equal_the_accepted_steps(route, case, tmp_path_factory):
    """``ls.halvings`` is the sum of the result's ls_alpha_idx over the
    SQP iterations an instance ran whose line search took a step (index
    0 is alpha = 1, 7 is 1/128); rejections (-1) and frozen instances add
    nothing."""
    run = _run(route, tmp_path_factory, **case)
    res, got = run["on"], run["counters"]
    took = (res.pcg_iters >= 0) & (res.ls_alpha_idx >= 0)
    assert got["ls.halvings"] == int(res.ls_alpha_idx[took].sum())
    assert got["ls.searches"] - got["ls.rejects"] == int(took.sum())


@pytest.mark.parametrize("keep", [0, profiling.KEEP_LAM_BYTES],
                         ids=["every-lam-reduced-at-once", "small-lam-kept"])
def test_nonfinite_lam_kept_or_reduced_across_shapes(keep, monkeypatch,
                                                     tmp_path_factory):
    """One session holding a single solve and a batched one (lam of two
    shapes), each lam kept as it is or reduced when its solve ends to
    whether each instance's lam is finite: the counters are the sums of the
    two solves' own."""
    want = [_run(route, tmp_path_factory, nan_lam0=True)["counters"]
            for route in ("pcg", "batched")]
    monkeypatch.setattr(profiling, "KEEP_LAM_BYTES", keep)
    with profiling.trace(str(tmp_path_factory.mktemp("trace"))):
        _solve("pcg", nan_lam0=True)
        _solve("batched", nan_lam0=True)
    got = profiling.counters()
    assert got == {k: want[0][k] + want[1][k] for k in got}
    assert got["pcg.nonfinite"] >= 2


def test_lam_reductions_run_unprofiled_and_turn_the_profiler_back_on(
        monkeypatch, tmp_path_factory):
    """Under a session, the recorder reduces a batch's lam with the
    profiler's per-operation callbacks off, and turns them back on: the
    session's trace holds the loop's one ``all`` (its stop-flag read) and
    not the recorder's two, and an operation after the solve."""
    monkeypatch.setattr(profiling, "KEEP_LAM_BYTES", 0)
    with profiling.trace(str(tmp_path_factory.mktemp("trace"))) as prof:
        _solve("batched", nan_lam0=True)
        torch.ones(3).cumsum(0)
    names = [e.get("name") for e in
             json.loads(Path(prof.trace_path).read_text())["traceEvents"]]
    assert names.count("aten::all") == ITERS - 1
    assert "aten::cumsum" in names
    assert profiling.counters()["pcg.nonfinite"] == ITERS
