"""The fleet's SQP iteration as a CUDA graph (``parallel/batched_cuda.py``
through ``solver/sqp_graph.py``).

On the CPU: which calls take the graph path (the route and the device
decide, nothing else), the device-index forms of ``sqp._put`` and
``sqp._at`` over a fleet's buffers, what separates two fleet graphs' keys,
and the graph path's buffer, copies and recording run eagerly on the CPU
against the eager fleet loop, bit for bit, with an instance that gives up
and stays frozen.  On a card (marker ``card``, skipped without one): the
graph path against the eager body bit for bit over a closed loop of 256
arms and over a chain of 3 with a frozen instance, results never
overwritten, and the counters and launch counts of a traced solve.  No
JAX.

On the chip: ``python3 -m pytest tests/test_torch_fleet_graph.py -m card -o
addopts="" --noconftest -q``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel import batched_cuda
from mpcgpu_tpu_torch.solver import sqp, sqp_graph
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


def _inputs(B: int, n: int, dtype, give_up: bool, device="cpu", start: int = 350,
            seed: int = 0):
    """B noisy copies of trace 0_0's rows start.. (numpy ``seed``): xu, lam0
    = 0, xs, ee; give_up: the last instance's goal NaN, so that its first
    line search fails (with rho 5e-3 over a rho_max of 4e-3 it gives up)."""
    rng = np.random.default_rng(seed)
    xu = load_xu_traj("0_0")[start:start + n][None] \
        + 0.02 * rng.standard_normal((B, n, 21))
    ee = np.broadcast_to(load_eepos_traj("0_0")[start:start + n], (B, n, 6)).copy()
    if give_up:
        ee[-1] = np.nan
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return (t(xu), torch.zeros((B, n, 14), dtype=dtype, device=device),
            t(xu[:, 0, :14]), t(ee))


def _bits(x):
    """x's bits: a float tensor viewed as integers of its width, so that two
    NaNs compare by their bits too."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b, strict=True))


def _graph_solve(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee, rho):
    return batched_cuda._solve_graph(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee,
                                     rho, DT, 0, False)


# ---- which calls engage the graph ------------------------------------------

# (merit_impl, the cost's mode, on a card) -> whether the graph engages
ENGAGE = {
    "auto": ("auto", "ee", True, True),
    "cuda": ("cuda", "ee", True, True),
    "plain": ("plain", "ee", True, False),
    "auto-joint-cost": ("auto", "joint", True, False),
    "cpu-auto": ("auto", "ee", False, False),
    "cpu-cuda": ("cuda", "ee", False, False),
}


@pytest.mark.parametrize("case", list(ENGAGE))
def test_the_route_and_the_device_decide_the_fleet_path(case, monkeypatch):
    """sqp_solve_batched_fused runs the graph path exactly with the batched
    K3 merits and xu on a card; CPU tensors and the plain merits run the
    eager loop.  The paths are stubbed, so xu can stand for a card's
    tensor here."""
    impl, mode, on_card, want = ENGAGE[case]
    taken = []
    monkeypatch.setattr(batched_cuda, "_solve_graph", lambda *a, **k: taken.append("graph"))
    monkeypatch.setattr(batched_cuda, "_solve_eager", lambda *a, **k: taken.append("eager"))
    xu = types.SimpleNamespace(device=torch.device("cuda:0" if on_card else "cpu"))
    batched_cuda.sqp_solve_batched_fused(None, CostConfig(mode=mode), SQPConfig(max_iter=2),
                                         PCGConfig(), xu, None, None, None, None, DT,
                                         merit_impl=impl)
    assert taken == ["graph" if want else "eager"]


# ---- a device index over a fleet's buffers ---------------------------------

@pytest.mark.parametrize("shape", [(5,), (3, 5)], ids=["arm", "fleet"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
def test_put_and_at_with_a_device_index_equal_the_int_index(shape, dtype):
    """sqp._put and sqp._at with ``it`` a device int64 (1,) write and read
    the same entries as with ``it`` an int, over one arm's (max_iter,)
    buffer and a fleet's (B, max_iter), values of int32 or bool."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-3, 9, shape, generator=gen).to(dtype)
    b = a.clone()
    for it in range(shape[-1]):
        value = torch.randint(-3, 9, shape[:-1], generator=gen).to(dtype)
        sqp._put(a, it, value)
        sqp._put(b, torch.tensor([it]), value)
        assert torch.equal(a, b)
        got = sqp._at(b, torch.tensor([it]))
        assert got.shape == shape[:-1] and got.dtype == dtype
        assert torch.equal(got, sqp._at(a, it)) and torch.equal(got, value)


# ---- what separates keys -----------------------------------------------------

_KEY_MODEL = iiwa14(torch.float32, device="cpu")


def _key_args(**change):
    model = change.pop("model", _KEY_MODEL)
    B, n = change.pop("B", 3), change.pop("n", N)
    dtype = change.pop("dtype", torch.float32)
    xu, lam, xs, ee = _inputs(B, n, dtype, give_up=False)
    args = dict(model=model, cost=CostConfig.for_knots(N), sqp_cfg=SQPConfig(max_iter=2),
                pcg_cfg=PCGConfig(max_iter=30), xu_b=xu, lam_b=lam, xs_b=xs, ee_b=ee,
                dt=DT, integrator_type=0, angle_wrap=False)
    args.update(change)
    return args


KEY_CHANGES = {
    "model": lambda: dict(model=iiwa14(torch.float32, device="cpu")),
    "dt": lambda: dict(dt=DT / 2),
    "B": lambda: dict(B=4),
    "N": lambda: dict(n=N + 4),
    "dtype": lambda: dict(dtype=torch.float64),
    "cost-r_cost": lambda: dict(cost=CostConfig(r_cost=2e-3)),
    "cost-qd_cost": lambda: dict(cost=dataclasses.replace(CostConfig.for_knots(N),
                                                          qd_cost=2e-4)),
    "sqp-max_iter": lambda: dict(sqp_cfg=SQPConfig(max_iter=3)),
    "sqp-rho_factor": lambda: dict(sqp_cfg=SQPConfig(max_iter=2, rho_factor=1.5)),
    "sqp-num_alphas": lambda: dict(sqp_cfg=SQPConfig(max_iter=2, num_alphas=6)),
    "sqp-mu": lambda: dict(sqp_cfg=SQPConfig(max_iter=2, mu=5.0)),
    "pcg-max_iter": lambda: dict(pcg_cfg=PCGConfig(max_iter=31)),
    "pcg-exit_tol": lambda: dict(pcg_cfg=PCGConfig(max_iter=30, exit_tol=1e-6)),
    "pcg-exit_criterion": lambda: dict(pcg_cfg=PCGConfig(max_iter=30,
                                                         exit_criterion="rnorm")),
    "integrator_type": lambda: dict(integrator_type=1),
    "angle_wrap": lambda: dict(angle_wrap=True),
}


@pytest.mark.parametrize("element", list(KEY_CHANGES) + ["merits"])
def test_each_element_of_the_fleet_key_separates_keys(element, monkeypatch):
    """Changing one thing a capture of the fleet's iteration bakes in gives
    another key and another cached graph; the same call again gives the
    same entry.  ``merits``: the wrapper the route's merits call."""
    base = _key_args()
    other = _key_args(**KEY_CHANGES.get(element, dict)())
    key = batched_cuda._graph_key(**base)
    assert key == batched_cuda._graph_key(**_key_args())
    g = batched_cuda._iteration_graph(**base)
    if element == "merits":
        monkeypatch.setattr(batched_cuda, "line_search_merits_batched",
                            batched_cuda.line_search_merits_batched_plain)
    assert key != batched_cuda._graph_key(**other)
    assert batched_cuda._iteration_graph(**other) is not g
    monkeypatch.undo()
    assert batched_cuda._iteration_graph(**_key_args()) is g


def test_the_arm_and_the_fleet_share_one_cache():
    """A fleet of one arm and the arm on the same problem get two entries,
    of their own bodies, in the one cache of at most MAX_GRAPHS."""
    args = _key_args(B=1)
    fleet = batched_cuda._iteration_graph(**args)
    arm = sqp_graph.iteration_graph(
        args["model"], args["cost"], args["sqp_cfg"], args["pcg_cfg"], args["xu_b"][0],
        args["lam_b"][0], args["xs_b"][0], args["ee_b"][0], DT, 2, 0, False, True)
    assert fleet is not arm and len(sqp_graph._GRAPHS) == 2
    assert (fleet.body, arm.body) == (batched_cuda._batched_iteration, sqp._iteration)
    assert fleet.wrappers == batched_cuda.WRAPPERS and arm.wrappers == sqp_graph.WRAPPERS
    for k in range(sqp_graph.MAX_GRAPHS):
        batched_cuda._iteration_graph(**_key_args(dt=(k + 2) * DT))
    assert len(sqp_graph._GRAPHS) == sqp_graph.MAX_GRAPHS
    assert batched_cuda._iteration_graph(**args) is not fleet


# ---- the graph path's buffer and copies, run eagerly on the CPU --------------

def _fleet_setup(dtype, max_iter: int):
    model, cost = iiwa14(dtype, device="cpu"), CostConfig.for_knots(N)
    sqp_cfg = SQPConfig(max_iter=max_iter, rho_max=4e-3)
    pcg_cfg = PCGConfig(max_iter=30, exit_tol=1e-6)
    return model, cost, sqp_cfg, pcg_cfg


@pytest.mark.parametrize("max_iter", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_the_fleet_graph_path_on_the_cpu_equals_the_eager_loop(dtype, max_iter):
    """_solve_graph with CPU tensors (no capture: every iteration runs the
    buffer's step eagerly, its index a tensor) equals the eager fleet loop
    bit for bit over a chain of three solves, each from the last one's
    plan, multipliers and rho: three instances, the last of which gives up
    in iteration 0 (a NaN goal, rho 5e-3 over a rho_max of 4e-3) and stays
    frozen; no result changes after later solves; one cached entry."""
    model, cost, sqp_cfg, pcg_cfg = _fleet_setup(dtype, max_iter)
    xu, lam, xs, ee = _inputs(3, N, dtype, give_up=True)
    rho = torch.tensor([1e-3, 2e-3, 5e-3], dtype=dtype)
    a = b = types.SimpleNamespace(xu=xu, lam=lam, rho=rho)
    kept = []
    for k in range(3):
        a = batched_cuda.sqp_solve_batched_fused(model, cost, sqp_cfg, pcg_cfg, a.xu,
                                                 a.lam, xs, ee, a.rho, DT,
                                                 merit_impl="cuda")
        b = _graph_solve(model, cost, sqp_cfg, pcg_cfg, b.xu, b.lam, xs, ee, b.rho)
        assert _same(a, b), k
        kept.append((b, [t.clone() for t in b]))
    assert all(_same(res, copy) for res, copy in kept)
    first = kept[0][0]
    assert first.gave_up.tolist() == [False, False, True]
    assert first.sqp_iters.tolist() == [max_iter, max_iter, 1]
    assert bool((first.pcg_iters[-1, 1:] == -1).all())
    assert len(sqp_graph._GRAPHS) == 1


@pytest.mark.parametrize("replayed", [False, True], ids=["eager-steps", "replays"])
def test_fleet_graph_path_recording(replayed, monkeypatch, tmp_path):
    """Under a profiler session the fleet's graph path records sqp.solve
    (batch 3), one sqp.stop_read per later iteration and (replays) one
    sqp.replay per iteration, no phase of the eager loop, counters equal to
    the eager loop's, sqp.replays one per replayed iteration, no capture on
    the CPU, and per iteration the K8a host counts the eager body counts
    (stubbed here: the plain version counts none); its kept lams are
    copies.  ``replays``: a stand-in graph whose replay runs the buffer's
    step."""
    model, cost, sqp_cfg, pcg_cfg = _fleet_setup(torch.float32, 2)
    xu, lam, xs, ee = _inputs(3, N, torch.float32, give_up=False)
    rho = torch.full((3,), 1e-3)
    monkeypatch.setattr(batched_cuda, "_k8a_counts",
                        lambda model, xu_b: (("k8a.knot_stages", 5), ("k8a.knots", 4)))
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            want = batched_cuda.sqp_solve_batched_fused(
                model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee, rho, DT,
                merit_impl="cuda")
    eager = profiling.counters()
    if replayed:
        g = batched_cuda._iteration_graph(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs,
                                          ee, DT, 0, False)
        g.graph = object()
        monkeypatch.setattr(sqp_graph.IterationGraph, "replay", lambda self: self.step())
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            got = _graph_solve(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee, rho)
    assert _same(want, got)
    spans = profiling.spans()
    names = [s.name for s in spans]
    iters = int(want.sqp_iters.max())
    assert iters == 2
    assert names.count("sqp.solve") == 3
    assert {s.batch for s in spans} == {3}
    assert names.count("sqp.stop_read") == 3 * (iters - 1)
    assert names.count("sqp.replay") == (3 * iters if replayed else 0)
    assert not {"sqp.kkt", "sqp.linsys", "sqp.dz", "sqp.merits", "sqp.step"} & set(names)
    counts = profiling.counters()
    assert {k: counts[k] for k in profiling.COUNTER_NAMES} == \
        {k: eager[k] for k in profiling.COUNTER_NAMES}
    assert counts["pcg.solves"] == 3 * 3 * iters
    assert counts["sqp.replays"] == (3 * iters if replayed else 0)
    assert counts["sqp.captures"] == eager["sqp.captures"] == eager["sqp.replays"] == 0
    assert (counts["k8a.knot_stages"], counts["k8a.knots"]) == \
        (eager["k8a.knot_stages"], eager["k8a.knots"]) == (5 * 3 * iters, 4 * 3 * iters)
    (g,) = sqp_graph._GRAPHS.values()
    kept = [lam for *_, lams in profiling._RECORDER.solves for lam in lams]
    assert len(kept) == 3 * iters
    assert all(t.untyped_storage().data_ptr() != g.flat.buf.untyped_storage().data_ptr()
               for t in kept)


# ---- on the card ------------------------------------------------------------

def _eager(monkeypatch):
    """Every later solve, the arm's and the fleet's, runs the eager loop
    (the reference)."""
    monkeypatch.setattr(sqp, "graph_engages", lambda *a: False)


def _card_cfgs(n: int = 64):
    cost = CostConfig.for_knots(n)
    sqp_cfg = SQPConfig(max_iter=2, max_time_us=None)
    pcg_cfg = PCGConfig(max_iter=PCGConfig.tuned_max_iter(n), exit_tol=1e-5)
    return cost, sqp_cfg, pcg_cfg


@pytest.mark.card
def test_card_fleet_closed_loop_bit_for_bit(card, monkeypatch):
    """24 updates of the on-device closed loop of 256 arms (plant, shift, N
    = 64 from trace 0_0's calm rows 220-300, starts + 0.05 N(0, 1)): every
    solve's every output and the tracking errors of the graph path equal
    the eager body's bit for bit; one capture, every later SQP iteration a
    replay."""
    from mpcgpu_tpu_torch.config import SimConfig
    from mpcgpu_tpu_torch.sim import mpc

    model = iiwa14(torch.float32, device=card)
    cost, sqp_cfg, pcg_cfg = _card_cfgs()
    xu_tr, ee_tr = load_xu_traj("0_0")[220:300], load_eepos_traj("0_0")[220:300]
    solve = mpc.sqp_solve_batched_fused

    def run():
        results = []

        def recorded(*a, **k):
            results.append(solve(*a, **k))
            return results[-1]

        with monkeypatch.context() as m:
            m.setattr(mpc, "sqp_solve_batched_fused", recorded)
            out = mpc.simulate_mpc_ondevice_batched(
                model, xu_tr, ee_tr, 64, DT, 256, cost=cost, sqp_cfg=sqp_cfg,
                pcg_cfg=pcg_cfg, sim_cfg=SimConfig(max_control_updates=24),
                linsys="pcg_cuda")
        return out, results

    with profiling.trace():
        got, got_res = run()
        torch.cuda.synchronize()
    counts = profiling.counters()
    with monkeypatch.context() as m:
        _eager(m)
        want, want_res = run()
    assert len(got_res) == len(want_res) == 24
    for k, v in want.items():
        assert (torch.equal(v, got[k]) if isinstance(v, torch.Tensor)
                else v == got[k]), k
    assert all(_same(a, b) for a, b in zip(got_res, want_res))
    iters = sum(int(r.sqp_iters.max()) for r in want_res)
    assert counts["sqp.captures"] == 1
    assert counts["sqp.replays"] + 1 == iters
    assert counts["pcg.solves"] == sum(int((r.pcg_iters >= 0).sum()) for r in want_res)


@pytest.mark.card
def test_card_fleet_with_a_frozen_instance_bit_for_bit(card, monkeypatch):
    """Three arms, the last of which gives up in iteration 0 and stays
    frozen, over a chain of six 3-iteration solves, each from the last
    one's plan, multipliers and rho: the graph path equals the eager body
    bit for bit."""
    model = iiwa14(torch.float32, device=card)
    cost, _, pcg_cfg = _card_cfgs()
    sqp_cfg = SQPConfig(max_iter=3, max_time_us=None, rho_max=4e-3)
    xu, lam, xs, ee = _inputs(3, 64, torch.float32, give_up=True, device=card, start=220)
    rho = torch.tensor([1e-3, 2e-3, 5e-3], device=card)

    def chain():
        out, r = [], types.SimpleNamespace(xu=xu, lam=lam, rho=rho)
        for _ in range(6):
            r = batched_cuda.sqp_solve_batched_fused(model, cost, sqp_cfg, pcg_cfg,
                                                     r.xu, r.lam, xs, ee, r.rho, DT)
            out.append(r)
        torch.cuda.synchronize()
        return out

    got = chain()
    with monkeypatch.context() as m:
        _eager(m)
        want = chain()
    assert all(_same(a, b) for a, b in zip(got, want))
    assert got[0].gave_up.tolist() == [False, False, True]
    assert got[0].sqp_iters.tolist() == [3, 3, 1]


@pytest.mark.card
def test_card_fleet_results_survive_later_solves(card):
    """A fleet's result equals its copy after later solves from other
    inputs."""
    model = iiwa14(torch.float32, device=card)
    cost, sqp_cfg, pcg_cfg = _card_cfgs()
    xu, lam, xs, ee = _inputs(256, 64, torch.float32, False, card, start=220)
    rho = torch.full((256,), 1e-3, device=card)
    solve = batched_cuda.make_batched_fused_solver(model, cost, sqp_cfg, pcg_cfg, DT)
    first = solve(xu, lam, xs, ee, rho)
    kept = [t.clone() for t in first]
    for seed in (1, 2, 3):
        xu2, _, xs2, ee2 = _inputs(256, 64, torch.float32, False, card, 230, seed)
        solve(xu2, first.lam, xs2, ee2, first.rho)
    torch.cuda.synchronize()
    assert _same(first, kept)


@pytest.mark.card
def test_card_fleet_counters_and_launches_equal_on_both_paths(card, monkeypatch):
    """Over 8 chained solves of 256 arms under a profiler session: the
    counters, K8a's host counts and the four wrappers' launch counts of the
    graph path equal the eager body's; sqp.replays counts every SQP
    iteration, sqp.captures none (captured before the session); then one
    capture for a new key (another dt), in its traced solve."""
    model = iiwa14(torch.float32, device=card)
    cost, sqp_cfg, pcg_cfg = _card_cfgs()
    xu0, lam0, xs, ee = _inputs(256, 64, torch.float32, False, card, start=220)
    rho0 = torch.full((256,), 1e-3, device=card)

    def chain(dt=DT, n=8):
        for w in batched_cuda.WRAPPERS:
            w.launches = 0
        r = types.SimpleNamespace(xu=xu0, lam=lam0, rho=rho0)
        iters = 0
        with profiling.trace():
            for _ in range(n):
                r = batched_cuda.sqp_solve_batched_fused(model, cost, sqp_cfg, pcg_cfg,
                                                         r.xu, r.lam, xs, ee, r.rho, dt)
                iters += int(r.sqp_iters.max())
            torch.cuda.synchronize()
        return r, profiling.counters(), [w.launches for w in batched_cuda.WRAPPERS], iters

    batched_cuda.sqp_solve_batched_fused(model, cost, sqp_cfg, pcg_cfg, xu0, lam0, xs,
                                         ee, rho0, DT)
    got, got_counts, got_launches, iters = chain()
    with monkeypatch.context() as m:
        _eager(m)
        want, want_counts, want_launches, _ = chain()
    assert _same(got, want)
    assert got_launches == want_launches == [iters] * 4
    names = profiling.COUNTER_NAMES + ("k8a.knot_stages", "k8a.knots")
    assert {k: got_counts[k] for k in names} == {k: want_counts[k] for k in names}
    assert got_counts["k8a.knots"] == iters * 256 * 64 > 0
    assert got_counts["sqp.replays"] == iters
    assert got_counts["sqp.captures"] == want_counts["sqp.replays"] == 0
    _, new_key, _, new_iters = chain(dt=DT * 0.75, n=1)
    assert new_key["sqp.captures"] == 1 and new_key["sqp.replays"] == new_iters - 1
