"""``replay_host_us_per_iter.fleet``: the host time of one replay of the
fleet's SQP iteration graph, entered for the fleet's cell and read by the
arm's reader (``metrics/replay_host_us_per_iter.py``) from the fleet's
``sqp.replay`` spans; None where the fleet's solves replay nothing (its
eager loop, as at a program without the fleet's graph)."""

import pytest

from mpcgpu_tpu_torch.utils import profiling
from portbench import harness

SPEC = harness.load_spec()
B = 256


def _span(name, start_us, end_us, solve, iteration=None, parent=None):
    return profiling.Span(name, int(start_us * 1e3), int(end_us * 1e3), parent,
                          solve, iteration, B)


# one fleet solve of two SQP iterations, both replays, and the stop read
# between them
GRAPH = [
    _span("sqp.solve", 0, 2000, 0),
    _span("sqp.replay", 10, 160, 0, 0, 0), _span("sqp.stop_read", 160, 1500, 0, 0, 0),
    _span("sqp.replay", 1500, 1610, 0, 1, 0),
]
# the same solve on the eager loop: its phases, no replay
EAGER = [_span("sqp.solve", 0, 3400, 0)] + [
    _span(name, 100 * k, 100 * k + 90, 0, k // 6, 0)
    for k, name in enumerate(("sqp.kkt", "sqp.linsys", "sqp.dz", "sqp.merits",
                              "sqp.step", "sqp.stop_read", "sqp.kkt", "sqp.linsys",
                              "sqp.dz", "sqp.merits", "sqp.step"))]


def test_the_fleet_entry():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    m = entries["replay_host_us_per_iter.fleet"]
    assert m == dict(name="replay_host_us_per_iter.fleet", unit="us", better="lower",
                     source="program_span",
                     layer="batched SQP, host side (parallel/batched_cuda.py)",
                     moves="instance_updates_per_s.fleet", workloads=["fleet256-calm"])
    assert m["layer"] == entries["host_us_per_update.fleet"]["layer"]
    assert "graph_replay_pct.fleet" not in entries
    plan = harness.cell_plan(SPEC, "fleet256-calm")
    assert "replay_host_us_per_iter.fleet" in [p["name"] for p in plan["per_layer"]]
    for cell in ("arm64-calm", "arm512-calm"):
        plan = harness.cell_plan(SPEC, cell)
        assert "replay_host_us_per_iter.fleet" not in [p["name"] for p in plan["per_layer"]]


@pytest.mark.parametrize("spans, want", [(GRAPH, (150 + 110) / 2), (EAGER, None)],
                         ids=["graph", "eager"])
def test_the_reader_on_a_fleets_spans(spans, want, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    plan = harness.cell_plan(SPEC, "fleet256-calm")
    entry = [m for m in plan["per_layer"] if m["name"] == "replay_host_us_per_iter.fleet"]
    rec = dict(traced=dict(window_s=1.0, busy_s=0.5))
    got = harness.per_layer(entry, rec)
    if want is None:
        assert got == {}
    else:
        assert got == {"replay_host_us_per_iter.fleet": dict(
            value=pytest.approx(want, rel=1e-12), unit="us")}
