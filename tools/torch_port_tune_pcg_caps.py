#!/usr/bin/env python3
"""Re-derive the port's PCG iteration caps on the card.

The reference ships an empirical PCG_MAX_ITER table "found using
experiments" (settings.cuh:123-144: N=32:173, 64:167, 128:167, 256:118,
512:67).  This is the port's copy of the JAX package's
``tools/tune_pcg_caps.py``: for each horizon it runs the on-device closed
loop (``simulate_mpc_ondevice``, IIWA-14, f32, trace 0_0 rows [:300],
``SQPConfig(max_iter=2, max_time_us=None)``) over a sweep of iteration
caps and prints one JSON line per (N, tol, cap) with the JAX tool's fields
(``us_per_control_step``: the median wall of the ensemble's loops over
their updates; ``avg_tracking_error``, ``final_tracking_error``,
``mean_pcg_iters``, ``max_iter_exit_pct`` of the unperturbed loop) and:

  * ``latency_us``: us per update as the slope of CUDA-event time (host
    clock on the CPU) between loops of steps // 3 and steps updates,
    median of 3, with the three values in ``latency_runs_us``;
  * ``k2_us_per_update``: K2's device time per update, from a
    ``torch.profiler`` window (``utils.profiling.trace``) of a loop of
    min(48, steps // 3) updates (null on the CPU, where no kernel runs);
  * ``ensemble_errors``: the mean tracking error of the unperturbed loop
    and of ``--ensemble`` loops from traces moved by one f32 ulp per entry
    (chip_smoke.py's construction), with their median and range (null
    where a loop makes no shift: fewer updates than one knot's time).

After each (N, tol) sweep that holds the reference cap it prints the cap
``select_cap`` picks (the rule is in its docstring), and every line names
the device it ran on.  Imports nothing of JAX.

    python3 tools/torch_port_tune_pcg_caps.py [--knots 32 64 128]
        [--caps 20 40 80 120 (+ the reference cap)] [--steps 600]
        [--sqp-iters 2] [--exit-criterion eta] [--tols 1e-5]
        [--device cuda] [--ensemble 8]
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

TRACE_ROWS = 300           # rows of trace 0_0 the loops track
PROFILE_UPDATES = 48       # the profiled window (updates)
ERROR_RULE = 1.05          # the "5% rule" on the ensemble's median error
K2_KERNEL = "pcg_dz_kernel<true, false>"   # K2's kernel in the profiler


def select_cap(rows, ref_cap: int) -> int:
    """The cap for one horizon from its sweep's rows (dicts with
    ``pcg_cap``, ``finite``, ``ensemble_median``, ``latency_us`` and
    ``latency_runs_us``).  A cap C below ``ref_cap`` passes when every loop
    at C is finite, its median ensemble error is at most ERROR_RULE times
    the reference cap's, and its latency is below the reference cap's by
    more than the larger of the two caps' run-to-run ranges.  Returns the
    fastest cap that passes, else ``ref_cap`` (also where the errors are
    null)."""
    ref = next(r for r in rows if r["pcg_cap"] == ref_cap)
    if ref["ensemble_median"] is None:
        return ref_cap
    spread = lambda r: max(r["latency_runs_us"]) - min(r["latency_runs_us"])
    passing = [r for r in rows
               if r["pcg_cap"] < ref_cap and r["finite"]
               and r["ensemble_median"] is not None
               and r["ensemble_median"] <= ERROR_RULE * ref["ensemble_median"]
               and ref["latency_us"] - r["latency_us"] > max(spread(r), spread(ref))]
    return min(passing, key=lambda r: r["latency_us"])["pcg_cap"] if passing else ref_cap


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" on
    the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]


def elapsed_us(torch, device, fn) -> float:
    """Time of fn(): CUDA events on the card, the host clock on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) * 1e3
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e6


def k2_device_us(prof):
    """K2's device time (us) and calls in a profiler window; (None, 0)
    where no K2 kernel ran."""
    us, calls = 0.0, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        if K2_KERNEL in ev.key and dev_us:
            us += dev_us
            calls += ev.count
    return (us if calls else None), calls


def ulp_traces(xu: np.ndarray, count: int) -> list:
    """``count`` copies of the trace with every entry moved by one f32 ulp
    up or down at random (numpy seed 2), as chip_smoke.py builds its
    ensemble."""
    rng = np.random.default_rng(2)
    xu32 = xu.astype(np.float32)
    out = []
    for _ in range(count):
        way = np.where(rng.random(xu32.shape) < 0.5, -np.inf, np.inf).astype(np.float32)
        out.append(np.nextafter(xu32, way).astype(np.float64))
    return out


def sweep_row(torch, device, model, xu_traj, ee_traj, N, cap, tol, args, card):
    """One (N, tol, cap) point: the row described in the module docstring."""
    from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
    from mpcgpu_tpu_torch.sim.mpc import simulate_mpc_ondevice
    from mpcgpu_tpu_torch.utils.profiling import WallTimer, trace

    pcfg = PCGConfig(max_iter=cap, exit_tol=tol, exit_criterion=args.exit_criterion)
    scfg = SQPConfig(max_iter=args.sqp_iters, max_time_us=None)

    def loop(updates, xu=xu_traj):
        return simulate_mpc_ondevice(model, xu, ee_traj, N, 1 / 64.0, sqp_cfg=scfg,
                                     pcg_cfg=pcfg,
                                     sim_cfg=SimConfig(max_control_updates=updates))

    lo, hi = max(1, args.steps // 3), args.steps
    window = min(PROFILE_UPDATES, lo)
    loop(lo)                                    # warm: kernels built, caches filled
    with trace() as prof:
        loop(window)
    # no kernel runs on the CPU: nothing to read from the window there
    k2_us, k2_calls = k2_device_us(prof) if device.type == "cuda" else (None, 0)

    slopes = []
    for _ in range(3):
        t = {k: elapsed_us(torch, device, lambda: loop(k)) for k in (lo, hi)}
        slopes.append((t[hi] - t[lo]) / (hi - lo))

    timer, runs = WallTimer(), []
    for xu in [xu_traj] + ulp_traces(xu_traj, args.ensemble):
        out = {}
        with timer.measure(out):
            out.update(loop(args.steps, xu))
        runs.append(out)
    main = runs[0]
    steps = int(main["control_updates"])
    means = [float(r["tracking_errors"].double().mean())
             if r["tracking_errors"].numel() else None for r in runs]
    shifted = None not in means
    finite = all(bool(torch.isfinite(r["tracking_errors"]).all())
                 and bool(torch.isfinite(r["xs_path"]).all())
                 and math.isfinite(float(r["final_tracking_error"])) for r in runs)
    it = main["pcg_iters"].cpu()
    live = it[it >= 0].double()
    return dict(
        knots=N, pcg_cap=cap, exit_criterion=args.exit_criterion, exit_tol=tol,
        sqp_iters=args.sqp_iters, control_updates=steps,
        us_per_control_step=statistics.median(timer.samples_us) / steps,
        avg_tracking_error=means[0],
        final_tracking_error=float(main["final_tracking_error"]),
        mean_pcg_iters=float(live.mean()) if live.numel() else None,
        max_iter_exit_pct=(100.0 * float((live >= cap).double().mean())
                           if live.numel() else None),
        latency_us=statistics.median(slopes), latency_runs_us=slopes,
        latency_lengths=[lo, hi],
        k2_us_per_update=None if k2_us is None else k2_us / window,
        k2_calls_per_update=k2_calls / window, profiled_updates=window,
        ensemble_errors=means,
        ensemble_median=statistics.median(means) if shifted else None,
        ensemble_range=[min(means), max(means)] if shifted else None,
        finite=finite,
        device=card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--knots", type=int, nargs="*", default=[32, 64, 128])
    ap.add_argument("--caps", type=int, nargs="*", default=None,
                    help="caps to sweep (default: 20 40 80 120 and each "
                    "horizon's reference cap, PCGConfig.tuned_max_iter(N))")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--sqp-iters", type=int, default=2)
    ap.add_argument("--exit-criterion", default="eta", choices=["eta", "rnorm"])
    ap.add_argument("--tols", type=float, nargs="*", default=[1e-5])
    ap.add_argument("--device", default="cuda",
                    help="the loops' device (cpu: the plain versions)")
    ap.add_argument("--ensemble", type=int, default=8,
                    help="loops from 1-ulp trace changes beside the unperturbed one")
    args = ap.parse_args(argv)

    import torch

    from mpcgpu_tpu_torch.config import PCGConfig
    from mpcgpu_tpu_torch.models import iiwa14
    from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_port_tune_pcg_caps: no CUDA device; pass --device cpu to "
              "run the plain versions", file=sys.stderr)
        return 2
    card = card_line(device)
    print(f"device: {card}", flush=True)
    model = iiwa14(torch.float32, device=device)
    xu_traj = load_xu_traj("0_0")[:TRACE_ROWS]
    ee_traj = load_eepos_traj("0_0")[:TRACE_ROWS]

    for N in args.knots:
        ref_cap = PCGConfig.tuned_max_iter(N)
        caps = args.caps if args.caps is not None else [20, 40, 80, 120, ref_cap]
        for tol in args.tols:
            rows = []
            for cap in caps:
                rows.append(sweep_row(torch, device, model, xu_traj, ee_traj, N,
                                      cap, tol, args, card))
                print(json.dumps(rows[-1]), flush=True)
            if ref_cap in caps:
                print(json.dumps(dict(knots=N, exit_tol=tol, ref_cap=ref_cap,
                                      selected_cap=select_cap(rows, ref_cap),
                                      device=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
