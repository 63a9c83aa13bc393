#!/usr/bin/env python3
"""Where a control update's host time goes, by the program's own spans.

Runs one cell of the port's benchmark (``portbench/``: its configuration,
traffic, driver and closed loop; ``--seed`` draws the starts) on the card,
warms it up as the benchmark does, then:

  * with ``--first-pairs``, first of all measures what recording costs in
    the process's first profiler session, as ``--pairs`` below;
  * traces ``--updates`` control updates under torch.profiler, as the
    benchmark's traced segment does, and splits each update's solve call
    into the spans of ``mpcgpu_tpu_torch/utils/profiling.py``: the kernel
    wrappers (``sqp.kkt``, ``sqp.linsys``, ``sqp.dz``, ``sqp.merits``), the
    loop's own ops (``sqp.step``), or on the CUDA graph path the replays
    (``sqp.replay``), the stop-flag wait (``sqp.stop_read``) and the rest
    of ``sqp.solve``; it compares the solve spans with the
    harness's host time of the solve calls, the counters with the traced
    PCG counts, and puts the segment's device idle gaps down to the span
    the host was in at each gap's middle (outside any: the plant, the
    shift and the harness);
  * splits ``--updates`` updates the same way with no profiler session,
    recording forced on by patching the profiler's flag here (the spans'
    profiler ranges then inert): the untraced run's split;
  * measures what recording costs: ``--pairs`` pairs of updates under one
    profiler session, recording on in one and off in the other (the
    profiler's flag patched here, off first in even pairs), and the same
    with no session;
  * times the off path on this host: ``profiling.solve_trace`` with no
    session, and a boundary's check;
  * writes a short ``profiling.trace()`` of three updates and counts the
    program's spans and the kernels on its timeline.

    python3 tools/torch_port_trace_spans.py --cell arm64-calm [--seed 11]
        [--updates 200] [--pairs 300] [--first-pairs 0] [--out FILE]
        [--chrome-dir DIR]

Prints one JSON object and writes it to ``--out``.  Needs a CUDA card;
imports nothing of JAX.
"""

import argparse
import collections
import contextlib
import json
import statistics
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("sqp.kkt", "sqp.linsys", "sqp.dz", "sqp.merits", "sqp.step",
          "sqp.replay", "sqp.stop_read")
WRAPPERS = ("sqp.kkt", "sqp.linsys", "sqp.dz", "sqp.merits")


def make_loop(torch, cell: str, seed: int, dev):
    from portbench import harness

    plan = harness.cell_plan(harness.load_spec(), cell)
    cfg = plan["cfg"]
    drv = harness.load_module(harness.HERE / "drivers" / f"{cfg['driver']}.py",
                              f"portbench.drivers.{cfg['driver']}").Driver(cfg, dev)
    loop = harness.Loop(torch, cfg, plan["mix"], drv, seed, dev)
    for _ in range(cfg["warmup_updates"]):
        loop.update()
    loop.reset()
    loop.sync()
    return loop, cfg


def split(spans, updates: int) -> dict:
    """Each phase's host time per update (us), the solve's, the rest."""
    total = collections.Counter()
    for s in spans:
        total[s.name] += (s.end_ns - s.start_ns) / 1e3
    per = {k: v / updates for k, v in total.items()}
    phases = sum(per.get(p, 0.0) for p in PHASES)
    solve = per["sqp.solve"]
    return dict(
        per_update_us={k: per[k] for k in sorted(per)},
        wrappers_us=sum(per.get(p, 0.0) for p in WRAPPERS),
        step_us=per.get("sqp.step", 0.0), replay_us=per.get("sqp.replay", 0.0),
        wait_us=per.get("sqp.stop_read", 0.0),
        enqueue_us=solve - per.get("sqp.stop_read", 0.0),
        rest_us=solve - phases, phase_cover=phases / solve,
        iterations=sum(s.name in ("sqp.kkt", "sqp.replay") for s in spans))


class _SpansAndDevice:
    """A profile's events less the host operations that are not the
    program's spans, so that ``portbench/trace.py::reduce`` names each idle
    gap by the innermost span the host was in."""

    def __init__(self, prof):
        from mpcgpu_tpu_torch.utils import profiling
        from portbench import trace

        self._events = [e for e in prof.events() if e.device_type.name != "CPU"
                        or e.name == trace.WINDOW or e.name in profiling.SPAN_NAMES]

    def events(self):
        return self._events


def idle_by_span(prof) -> dict:
    """The segment's device idle time (us) by the program span the host was
    in at each gap's middle (``sqp.solve`` alone: its set-up before the
    loop), as ``portbench/trace.py`` finds the gaps; the time outside any
    span is the plant's, the shift's and the harness's."""
    from mpcgpu_tpu_torch.utils import profiling
    from portbench import trace

    red = trace.reduce(_SpansAndDevice(prof))
    outside = "outside the solve (plant, shift, harness)"
    idle = {(outside if k == "python between operations" else k): 1e6 * v
            for k, v in red["idle_gaps"]}
    device_spans = sorted({e.name for e in prof.events()
                           if e.device_type.name != "CPU" and e.name in profiling.SPAN_NAMES})
    return dict(idle_us=idle, window_us=1e6 * red["window_s"],
                idle_total_us=1e6 * (red["window_s"] - red["busy_s"]),
                device_events_named_sqp=device_spans)


def traced_segment(torch, loop, updates: int) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    from mpcgpu_tpu_torch.utils import profiling
    from portbench import harness, trace

    profiling.reset()
    rec = harness.new_rec()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            for _ in range(updates):
                loop.update(rec)
    iters = torch.stack(rec["pcg_iters"]).cpu()
    spans, counts = profiling.spans(), profiling.counters()
    out = split(spans, updates)
    solve_s = sum(s.end_ns - s.start_ns for s in spans if s.name == "sqp.solve") / 1e9
    readers = {}
    traced = dict(trace.reduce(prof), pcg_iters=iters, host_s=rec["host_s"])
    for base in ("solve_enqueue_us_per_update", "sync_wait_us_per_update",
                 "launch_host_us_per_iter", "step_host_us_per_iter",
                 "pcg_cap_exit_pct", "ls_reject_pct", "device_idle_pct"):
        mod = harness.load_module(harness.HERE / "metrics" / f"{base}.py", "m_" + base)
        readers[base] = mod.read(dict(traced=traced))
    out.update(
        updates=updates, solves=sum(s.name == "sqp.solve" for s in spans),
        host_us_per_update=1e6 * sum(rec["host_s"]) / updates,
        outside_solve_us=1e6 * sum(rec["host_s"]) / updates - out["per_update_us"]["sqp.solve"],
        solve_over_host=solve_s / sum(rec["host_s"]),
        counters=counts, pcg_iters_ge0=int((iters >= 0).sum()),
        readers=readers, idle=idle_by_span(prof),
        profiler_span_events=sum(1 for e in prof.events()
                                 if e.name.startswith("sqp.")),
        recorded_spans=len(spans))
    return out


def overhead(torch, loop, pairs: int, profiled: bool) -> dict:
    """The solve call's host time (us) of ``pairs`` pairs of updates, one
    with recording on and one with it off in each (the profiler's flag
    patched here; off first in even pairs), under one profiler session or
    (``profiled`` False) under none, where recording on records the spans
    and counters with inert profiler ranges."""
    import torch.autograd.profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    from mpcgpu_tpu_torch.utils import profiling
    from portbench import harness

    times = dict(on=[], off=[])
    session = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
    profiling.reset()
    with session:
        for p in range(pairs):
            for mode in (("off", "on") if p % 2 == 0 else ("on", "off")):
                autograd_profiler._is_profiler_enabled = mode == "on"
                rec = harness.new_rec()
                loop.update(rec)
                times[mode].append(1e6 * rec["host_s"][0])
        autograd_profiler._is_profiler_enabled = profiled
    profiling.reset()
    on, off = statistics.fmean(times["on"]), statistics.fmean(times["off"])
    diffs = [a - b for a, b in zip(times["on"], times["off"])]
    return dict(profiled=profiled, pairs=pairs, on_us=on, off_us=off, cost_us=on - off,
                cost_pct_of_on=100 * (on - off) / on,
                cost_se_us=statistics.stdev(diffs) / len(diffs) ** 0.5,
                median_pair_cost_us=statistics.median(diffs),
                on_quartiles_us=statistics.quantiles(times["on"], n=4),
                off_quartiles_us=statistics.quantiles(times["off"], n=4))


def unprofiled_split(torch, loop, updates: int) -> dict:
    """The spans of ``updates`` updates with no profiler session, recording
    forced on by the profiler's flag (its ranges then inert): the host
    split of an untraced run, the recording's own cost included."""
    import torch.autograd.profiler as autograd_profiler

    from mpcgpu_tpu_torch.utils import profiling
    from portbench import harness

    profiling.reset()
    rec = harness.new_rec()
    autograd_profiler._is_profiler_enabled = True
    try:
        for _ in range(updates):
            loop.update(rec)
    finally:
        autograd_profiler._is_profiler_enabled = False
    spans = profiling.spans()
    out = split(spans, updates)
    out.update(host_us_per_update=1e6 * sum(rec["host_s"]) / updates,
               solve_over_host=sum(s.end_ns - s.start_ns for s in spans
                                   if s.name == "sqp.solve") / 1e9 / sum(rec["host_s"]),
               counters=profiling.counters())
    profiling.reset()
    return out


def off_path() -> dict:
    """The cost of the off path on this host (us): the solve's entry check
    and one boundary's check of its recorder."""
    from mpcgpu_tpu_torch.utils import profiling

    n = 1_000_000
    entry = min(timeit.repeat("solve_trace(1)", number=n, repeat=5,
                              globals=dict(solve_trace=profiling.solve_trace))) / n
    check = min(timeit.repeat("if tr:\n    pass", setup="tr = None", number=n,
                              repeat=5)) / n
    empty = min(timeit.repeat("pass", number=n, repeat=5)) / n
    return dict(entry_us=1e6 * (entry - empty), check_us=1e6 * (check - empty))


def chrome(torch, loop, logdir: str | None) -> dict:
    """Three updates under profiling.trace(): the program's spans and the
    kernels in its Chrome trace, and the kernels that start inside a
    sqp.solve event on that one timeline."""
    from mpcgpu_tpu_torch.utils import profiling

    with profiling.trace(logdir) as prof:
        for _ in range(3):
            loop.update()
    events = json.loads(Path(prof.trace_path).read_text())["traceEvents"]
    spans = [e for e in events if str(e.get("name", "")).startswith("sqp.")
             and e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    solves = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in spans
              if e["name"] == "sqp.solve"]
    inside = sum(any(a <= float(k["ts"]) <= b for a, b in solves) for k in kernels)
    return dict(path=prof.trace_path, span_events=len(spans),
                span_names=sorted({e["name"] for e in spans}), kernels=len(kernels),
                kernels_starting_inside_a_solve=inside,
                first_names=[e["name"] for e in sorted(spans + kernels,
                                                       key=lambda e: float(e["ts"]))][:24])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--updates", type=int, default=200)
    ap.add_argument("--pairs", type=int, default=300)
    ap.add_argument("--first-pairs", type=int, default=0,
                    help="pairs of updates measured on and off under a profiler "
                    "before anything else records: the first traced segment's cost")
    ap.add_argument("--out", default=None)
    ap.add_argument("--chrome-dir", default=None,
                    help="where profiling.trace() writes its Chrome trace")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    loop, cfg = make_loop(torch, args.cell, args.seed, dev)
    result = dict(cell=args.cell, seed=args.seed, card=torch.cuda.get_device_name(0),
                  torch=torch.__version__)
    if args.first_pairs:
        result["overhead_first"] = overhead(torch, loop, args.first_pairs, profiled=True)
    result["traced"] = traced_segment(torch, loop, args.updates)
    result["unprofiled"] = unprofiled_split(torch, loop, args.updates)
    result["overhead"] = overhead(torch, loop, args.pairs, profiled=True)
    result["overhead_unprofiled"] = overhead(torch, loop, args.pairs, profiled=False)
    result["off_path"] = off_path()
    result["chrome"] = chrome(torch, loop, args.chrome_dir)
    text = json.dumps(result, indent=1)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
