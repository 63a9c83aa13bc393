"""Experiment statistics and CSV output (reference utils/experiment.cuh parity).

Provides the same stat schema as printStats / stats-to-CSV
(include/utils/experiment.cuh:16-142): mean/std/min/max/median/Q1/Q3 plus a
+-3 sigma histogram, and the `_overall_stats.csv` row format used by the
tracker scripts (examples/track_iiwa_pcg.cu:157-175).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np


def stats(values: Iterable[float]) -> dict:
    a = np.asarray(list(values), dtype=np.float64)
    if a.size == 0:
        return dict(count=0)
    q1, med, q3 = np.percentile(a, [25, 50, 75])
    return dict(
        count=int(a.size),
        mean=float(a.mean()),
        std=float(a.std()),
        min=float(a.min()),
        max=float(a.max()),
        median=float(med),
        q1=float(q1),
        q3=float(q3),
    )


def print_stats(values: Iterable[float], name: str = "", bins: int = 10) -> dict:
    """Print mean/std/min/max, percentiles, and a +-3 sigma histogram
    (experiment.cuh:16-75)."""
    s = stats(values)
    if s["count"] == 0:
        print(f"{name}: (no samples)")
        return s
    a = np.asarray(list(values), dtype=np.float64)
    print(
        f"{name}: n={s['count']} mean={s['mean']:.4g} std={s['std']:.4g} "
        f"min={s['min']:.4g} Q1={s['q1']:.4g} median={s['median']:.4g} "
        f"Q3={s['q3']:.4g} max={s['max']:.4g}"
    )
    lo, hi = s["mean"] - 3 * s["std"], s["mean"] + 3 * s["std"]
    if hi > lo:
        hist, edges = np.histogram(a, bins=bins, range=(lo, hi))
        total = hist.sum() or 1
        for h, e0, e1 in zip(hist, edges[:-1], edges[1:]):
            bar = "#" * int(40 * h / total)
            print(f"  [{e0:10.4g}, {e1:10.4g}) {h:6d} {bar}")
    return s


def write_overall_stats_csv(path, rows: Sequence[dict]) -> None:
    """Write the aggregate CSV the tracker scripts produce (track_iiwa_pcg.cu:157-175)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not rows:
        return
    keys = list(rows[0].keys())
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for r in rows:
            w.writerow(r)


def dump_tracking_data(outdir, prefix: str, mpc_stats, test_iter: int = 0) -> None:
    """Per-run .result files (dump_tracking_data, mpcsim.cuh:58-116)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    def dump(name, data):
        with (outdir / f"{prefix}_{test_iter}_{name}.result").open("w") as f:
            for item in data:
                f.write(f"{item}\n")

    flat_iters = [int(i) for arr in mpc_stats.linsys_iters for i in np.ravel(arr)]
    flat_exits = [int(i) for arr in mpc_stats.linsys_exits for i in np.ravel(arr)]
    dump("pcg_iters", flat_iters)
    dump("pcg_exits", flat_exits)
    dump("sqp_times", mpc_stats.sqp_times_us)
    dump("sqp_iters", mpc_stats.sqp_iters)
    dump("sqp_exits", [int(b) for b in mpc_stats.sqp_exits])
    dump("tracking_errors", mpc_stats.tracking_errors)
    with (outdir / f"{prefix}_{test_iter}_tracking_path.result").open("w") as f:
        for row in mpc_stats.tracking_path:
            f.write(",".join(str(v) for v in np.ravel(row)) + ",\n")
