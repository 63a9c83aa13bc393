"""The readers of the program's own spans and counters
(``mpcgpu_tpu_torch/utils/profiling.py``): each on a synthetic recorder
state, and each None on an empty record or an empty recorder; then the
traced segment of each cell on the CPU at a small size."""

import pytest
import torch

from mpcgpu_tpu_torch.utils import profiling
from portbench import harness

HERE = harness.HERE
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def _span(name, start_us, end_us, solve, iteration=None, parent=None):
    return profiling.Span(name, int(start_us * 1e3), int(end_us * 1e3), parent,
                          solve, iteration, 1)


# two solves: the first of two SQP iterations on the fused route (one
# stop-flag read, 300 us), the second of one iteration with a dz phase
SPANS = [
    _span("sqp.solve", 0, 1000, 0),
    _span("sqp.kkt", 10, 110, 0, 0, 0), _span("sqp.linsys", 110, 310, 0, 0, 0),
    _span("sqp.merits", 310, 360, 0, 0, 0), _span("sqp.step", 360, 510, 0, 0, 0),
    _span("sqp.stop_read", 510, 810, 0, 0, 0),
    _span("sqp.kkt", 810, 860, 0, 1, 0), _span("sqp.linsys", 860, 900, 0, 1, 0),
    _span("sqp.merits", 900, 920, 0, 1, 0), _span("sqp.step", 920, 1000, 0, 1, 0),
    _span("sqp.solve", 2000, 2500, 1),
    _span("sqp.kkt", 2000, 2100, 1, 0, 10), _span("sqp.linsys", 2100, 2200, 1, 0, 10),
    _span("sqp.dz", 2200, 2250, 1, 0, 10), _span("sqp.merits", 2250, 2300, 1, 0, 10),
    _span("sqp.step", 2300, 2500, 1, 0, 10),
]
COUNTERS = {"pcg.solves": 8, "pcg.cap_exits": 2, "ls.searches": 8, "ls.rejects": 1,
            "pcg.nonfinite": 0}
WANT = dict(
    solve_enqueue_us_per_update=(1500 - 300) / 2,
    sync_wait_us_per_update=300 / 2,
    launch_host_us_per_iter=(100 + 200 + 50 + 50 + 40 + 20 + 100 + 100 + 50 + 50) / 3,
    step_host_us_per_iter=(150 + 80 + 200) / 3,
    pcg_cap_exit_pct=25.0,
    ls_reject_pct=12.5)


def _reader(base):
    return harness.load_module(HERE / "metrics" / f"{base}.py", "m_" + base)


@pytest.mark.parametrize("base", sorted(WANT))
def test_reader_on_a_synthetic_recorder(base, monkeypatch):
    """The value from the synthetic spans and counters; None without a
    traced segment, and None from an empty recorder."""
    read = _reader(base).read
    traced = dict(traced=dict(window_s=1.0, busy_s=0.5))
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    monkeypatch.setattr(profiling, "counters", lambda: dict(COUNTERS))
    assert read(traced) == pytest.approx(WANT[base], rel=1e-12)
    assert read(dict(host_s=[])) is None
    monkeypatch.setattr(profiling, "spans", list)
    monkeypatch.setattr(profiling, "counters", lambda: dict.fromkeys(COUNTERS, 0))
    assert read(traced) is None


def test_the_metrics_are_entered_for_both_cells():
    """Each reader's ``.arm`` and ``.fleet`` entry, in its cell only."""
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for base in WANT:
        for tag, cell in (("arm", "arm64-calm"), ("fleet", "fleet256-calm")):
            m = entries[f"{base}.{tag}"]
            assert m["workloads"] == [cell]
            assert m["source"] == ("program_counter" if base.endswith("_pct")
                                   else "program_span")


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_segment_on_the_cpu_reads_the_program(cell):
    """The harness's traced segment at a small size on the CPU (the
    kernels' plain versions): every reader finds its numbers, the solves
    the counters count are the traced updates' PCG counts, and the solve
    spans lie inside the harness's host time of the solve calls."""
    torch.set_num_threads(2)
    plan = harness.cell_plan(SPEC, cell)
    cfg = dict(plan["cfg"], knots=16, pcg_max_iter=30)
    if cfg["batch"] > 1:
        cfg["batch"] = 3
    dev = torch.device("cpu")
    drv = harness.load_module(HERE / "drivers" / f"{cfg['driver']}.py",
                              f"portbench.drivers.{cfg['driver']}").Driver(cfg, dev)
    loop = harness.Loop(torch, cfg, plan["mix"], drv, 2 ** 31 + 7, dev)
    loop.update()
    profiling.reset()
    traced = harness.run_traced(torch, loop, 3)
    rec = dict(traced=traced)
    for base in WANT:
        assert _reader(base).read(rec) >= 0, base
    assert profiling.counters()["pcg.solves"] == int((traced["pcg_iters"] >= 0).sum())
    solves = [s for s in profiling.spans() if s.name == "sqp.solve"]
    assert len(solves) == 3
    assert sum(s.end_ns - s.start_ns for s in solves) <= sum(traced["host_s"]) * 1e9
