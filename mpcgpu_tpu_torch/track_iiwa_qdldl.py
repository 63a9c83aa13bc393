"""IIWA end-effector tracking with a direct linear-system solver, on the card.

Counterpart of ``examples/track_iiwa_qdldl.py`` for the port: the PCG
tracker's pipeline (``track_iiwa_pcg.py``) with the linear solve swapped for
a direct solver (the reference's qdldl path, include/qdldl/sqp.cuh).  The
flags are the JAX tracker's; ``--device`` (default cuda) picks where the
tracker runs.  The ``--linsys`` choices: ``ldl`` (default; the block
LDL^T as tensor ops), ``pcr`` (PCR as tensor ops), ``pcr_cuda`` (the PCR
kernel K7) and ``qdldl_host`` (the reference's literal host factor/solve
round trip every SQP iteration, qdldl/sqp.cuh:268-273).

Usage:  python -m mpcgpu_tpu_torch.track_iiwa_qdldl [--knots 32]
        [--steps 200] [--linsys ldl] [--save] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from mpcgpu_tpu_torch.config import SimConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.sim.mpc import simulate_mpc
from mpcgpu_tpu_torch.utils.experiment import (dump_tracking_data, print_stats,
                                               write_overall_stats_csv)
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--knots", type=int, default=32)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--traj", default="0_0")
    ap.add_argument("--grid", action="store_true",
                    help="iterate the reference's 5x5 start/goal grid with "
                         "its skip rule (track_iiwa_pcg.cu:30-43)")
    ap.add_argument("--test-iters", type=int, default=1)
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--linsys", default="ldl",
                    choices=["ldl", "pcr", "pcr_cuda", "qdldl_host"],
                    help="direct solver: 'ldl' = block LDL^T on the device "
                         "(default), 'pcr' = PCR as tensor ops, 'pcr_cuda' = "
                         "the PCR kernel, 'qdldl_host' = the reference's host "
                         "factor/solve round trip (qdldl/sqp.cuh:268-273)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tracker (default cuda)")
    return ap, ap.parse_args(argv)


def main(argv=None):
    ap, args = parse_args(argv)
    model = iiwa14(torch.float32, device=torch.device(args.device))
    traj_names = ([f"{i % 5}_{i // 5}" for i in range(25)
                   if not (i % 5 == i // 5 and i % 5 != 0)]
                  if args.grid else [args.traj])

    print(f"knots={args.knots} solver={args.linsys} (direct) device={args.device} "
          f"pairs={traj_names}")
    rows = []
    for name in traj_names:
        xu_traj = load_xu_traj(name)
        ee_traj = load_eepos_traj(name)
        if args.steps:
            if args.steps <= args.knots:
                ap.error(f"--steps ({args.steps}) must exceed --knots ({args.knots})")
            xu_traj, ee_traj = xu_traj[: args.steps], ee_traj[: args.steps]
        for it in range(args.test_iters):
            stats = simulate_mpc(
                model, xu_traj, ee_traj,
                knot_points=args.knots,
                timestep=1.0 / 64.0,
                sqp_cfg=SQPConfig(),
                sim_cfg=SimConfig(),
                linsys=args.linsys,
                verbose=args.verbose,
            )
            s = stats.summary()
            s["traj"] = name
            rows.append(s)
            print(name, s)
            print_stats(stats.sqp_times_us, "sqp solve time (us)")
            if args.save:
                dump_tracking_data(args.outdir, f"qdldl_{args.knots}_{name}", stats, it)
    if args.save:
        write_overall_stats_csv(f"{args.outdir}/qdldl_{args.knots}_overall_stats.csv", rows)
    return rows


if __name__ == "__main__":
    main()
