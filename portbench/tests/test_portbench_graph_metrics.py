"""The readers of the SQP graph path's span and counters
(``graph_replay_pct``, ``replay_host_us_per_iter``): each on a synthetic
recorder state, None on an empty record, an empty recorder and a
recorder without the graph path's names (a program without it), and each
entered for the arm's cell only."""

import pytest

from mpcgpu_tpu_torch.utils import profiling
from portbench import harness

HERE = harness.HERE
SPEC = harness.load_spec()


def _span(name, start_us, end_us, solve, iteration=None, parent=None):
    return profiling.Span(name, int(start_us * 1e3), int(end_us * 1e3), parent,
                          solve, iteration, 1)


# two solves of two SQP iterations each: the first ran its first iteration
# eagerly and captured the graph, then replayed; the second replayed both
SPANS = [
    _span("sqp.solve", 0, 1000, 0),
    _span("sqp.stop_read", 500, 700, 0, 0, 0), _span("sqp.replay", 700, 730, 0, 1, 0),
    _span("sqp.solve", 2000, 2600, 1),
    _span("sqp.replay", 2010, 2030, 1, 0, 3), _span("sqp.stop_read", 2030, 2400, 1, 0, 3),
    _span("sqp.replay", 2400, 2440, 1, 1, 3),
]
COUNTERS = {"pcg.solves": 4, "pcg.cap_exits": 0, "ls.searches": 4, "ls.rejects": 1,
            "pcg.nonfinite": 0, "sqp.replays": 3, "sqp.captures": 1}
WANT = dict(graph_replay_pct=75.0, replay_host_us_per_iter=(30 + 20 + 40) / 3)


def _reader(base):
    return harness.load_module(HERE / "metrics" / f"{base}.py", "m_" + base)


@pytest.mark.parametrize("base", sorted(WANT))
def test_reader_on_a_synthetic_recorder(base, monkeypatch):
    read = _reader(base).read
    traced = dict(traced=dict(window_s=1.0, busy_s=0.5))
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    monkeypatch.setattr(profiling, "counters", lambda: dict(COUNTERS))
    assert read(traced) == pytest.approx(WANT[base], rel=1e-12)
    assert read(dict(host_s=[])) is None
    monkeypatch.setattr(profiling, "spans", list)
    monkeypatch.setattr(profiling, "counters", lambda: dict.fromkeys(COUNTERS, 0))
    assert read(traced) is None
    # a program without the graph path: the eager loop's spans and counters
    monkeypatch.setattr(profiling, "spans", lambda: [s for s in SPANS
                                                     if s.name != "sqp.replay"])
    monkeypatch.setattr(profiling, "counters", lambda: {
        k: v for k, v in COUNTERS.items() if not k.startswith("sqp.")})
    assert read(traced) is None


def test_the_metrics_are_entered_for_the_arm_only():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for base in WANT:
        m = entries[f"{base}.arm"]
        assert m["workloads"] == ["arm64-calm"]
        assert m["moves"] == "update_p95_us.arm"
        assert m["layer"] == "SQP loop, host side (solver/sqp.py)"
        assert m["source"] == ("program_counter" if base.endswith("_pct")
                               else "program_span")
