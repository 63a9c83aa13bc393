"""The readings the check's limits are set from: for each seed, the
largest value of each number over a short window's sampled updates, for
the program and for the control (the reference in a lower arithmetic
answering the same updates in the program's place).  One process for all
seeds, set-up once.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 \\
        --seconds 8 [--modes tf32 bf16]

Prints one JSON line per seed.  Needs a CUDA card; the benchmark's own
runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def seed_readings(torch, plan, cfg, drv, seed: int, seconds: float, modes,
                  dev) -> dict:
    from portbench import check, harness

    loop = harness.Loop(torch, cfg, plan["mix"], drv, seed, dev)
    for _ in range(cfg["warmup_updates"]):
        loop.update()
    sampler = harness.Sampler(cfg["check_updates"], len(loop.sched.shift),
                              cfg["batch"], cfg["check_instances"], seed)
    rec = harness.run_window(torch, loop, seconds, sampler)
    del loop
    out = dict(seed=seed, updates=len(rec["latency_s"]))

    holds = plan["limits"]["plan_f32_holds"]

    def summary(r):
        s = {k: dict(value=check.statistic(r[k], k), count=len(r[k]),
                     max=float(r[k].max()) if len(r[k]) else None,
                     median=float(r[k].median()) if len(r[k]) else None)
             for k in check.NUMBERS}
        s["holds"] = int(r["holds"].sum())
        bad = r["pos"][r["nonfinite"] > 0]
        s["nonfinite_first_pos"] = float(bad.min()) if len(bad) else None
        # lam's error beside the reference's own f32 departure, by position
        s["lam_by_pos"] = sorted(zip(r["pos"].tolist(), r["lam_f32"].tolist(),
                                     r["lam_all"].tolist()))
        return s

    t0 = time.perf_counter()
    out["program"] = summary(check.readings(torch, sampler.kept, cfg, holds, dev))
    out["reference_s"] = time.perf_counter() - t0
    for mode in modes:
        control = check.Control(mode, dev, cfg)
        out[mode] = summary(check.readings(torch, sampler.kept, cfg, holds, dev,
                                           control))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--modes", nargs="*", default=["tf32", "bf16"])
    args = ap.parse_args()

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        sys.exit("readings: needs a CUDA card")
    dev = torch.device("cuda", 0)
    plan = harness.cell_plan(harness.load_spec(), args.workload)
    cfg = plan["cfg"]
    drv = harness.load_module(harness.HERE / "drivers" / f"{cfg['driver']}.py",
                              f"portbench.drivers.{cfg['driver']}").Driver(cfg, dev)
    for seed in args.seeds:
        print(json.dumps(seed_readings(torch, plan, cfg, drv, seed, args.seconds,
                                       args.modes, dev)), flush=True)


if __name__ == "__main__":
    main()
