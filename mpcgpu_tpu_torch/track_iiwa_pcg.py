"""IIWA end-effector tracking with the PCG linear-system solver, on the card.

Counterpart of ``examples/track_iiwa_pcg.py`` for the port: loads the
recorded start/goal trajectory pair, sweeps PCG exit tolerances, runs the
closed-loop MPC tracker, and writes per-run .result files plus an
``_overall_stats.csv`` (track_iiwa_pcg.cu:39-175).  The flags and defaults
are the JAX tracker's; ``--device`` (default cuda) picks where the tracker
runs.  Both loops run ``linsys="auto"``: the kernels' fused PCG on the card,
the plain PCG on the CPU.  ``--knot-shards S`` (with ``--ondevice``) runs
every solve knot-sharded (``parallel/sqp_sharded.py``, the pipelined slab
PCG: on the card the slab kernels K9a-c and K10a): over a virtual mesh of S
shards on the one device, or, launched as S processes by
``torch.distributed.run`` (``WORLD_SIZE`` set), over those processes, one
shard and one card each (``initialize_distributed`` from the launcher's
environment, ``make_host_aligned_mesh()``); then only rank 0 prints.

Usage:  python -m mpcgpu_tpu_torch.track_iiwa_pcg [--knots 32] [--steps 200]
        [--ondevice [--knot-shards S]] [--save] [--device cuda]
        python -m torch.distributed.run --nproc-per-node S \
            -m mpcgpu_tpu_torch.track_iiwa_pcg --ondevice --knot-shards S ...
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel.distributed import (initialize_distributed,
                                                   make_host_aligned_mesh)
from mpcgpu_tpu_torch.parallel.mesh import make_mesh
from mpcgpu_tpu_torch.sim.mpc import simulate_mpc, simulate_mpc_ondevice
from mpcgpu_tpu_torch.utils.experiment import (dump_tracking_data, print_stats,
                                               write_overall_stats_csv)
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

# reference tolerance sweeps (track_iiwa_pcg.cu:46-73)
TOL_SWEEP = {
    32: [5e-6, 7.5e-6, 5e-6, 2.5e-6, 1e-6],
    64: [5e-5, 7.5e-5, 5e-5, 2.5e-5, 1e-5],
}
DEFAULT_TOLS = [1e-5, 5e-5, 1e-4, 5e-4, 1e-3]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--knots", type=int, default=32)
    ap.add_argument("--steps", type=int, default=None, help="trajectory steps to track")
    ap.add_argument("--traj", default="0_0")
    ap.add_argument("--grid", action="store_true",
                    help="iterate the reference's 5x5 start/goal grid with "
                         "its skip rule (track_iiwa_pcg.cu:30-43) instead of "
                         "a single --traj pair")
    ap.add_argument("--tols", type=float, nargs="*", default=None)
    ap.add_argument("--exit-criterion", default="eta", choices=["eta", "rnorm"],
                    help="PCG exit metric: 'eta' = |r.P^-1 r| < tol (default), "
                         "'rnorm' = ||r|| < tol")
    ap.add_argument("--test-iters", type=int, default=1)
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--linsys", default="auto",
                    help="linear solver: auto (pcg_cuda on the card, pcg on "
                         "the CPU), pcg, pcg_cuda")
    ap.add_argument("--knot-shards", type=int, default=0,
                    help="with --ondevice: run every solve knot-sharded over "
                         "this many shards of a virtual mesh on the device, "
                         "or over as many processes of torch.distributed.run")
    ap.add_argument("--ondevice", action="store_true",
                    help="run the closed loop as device work with no "
                         "read-back per control step")
    ap.add_argument("--remove-jitters", type=int, default=0,
                    help="discarded warm-up solves before the tracking loop "
                         "(REMOVE_JITTERS, mpcsim.cuh:222-242; the reference "
                         "defaults to 100)")
    ap.add_argument("--forcing", default="fixed", choices=["fixed", "ew"],
                    help="per-SQP-iteration linear-solve tolerance schedule "
                         "(ew = Eisenstat-Walker-style loose first solve)")
    ap.add_argument("--live-print-path", action="store_true",
                    help="stream the measured state every control step "
                         "(LIVE_PRINT_PATH, settings.cuh:20-26)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tracker (default cuda)")
    return ap, ap.parse_args(argv)


def main(argv=None):
    ap, args = parse_args(argv)
    if args.knot_shards and not args.ondevice:
        ap.error("--knot-shards needs --ondevice")
    device = torch.device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        if args.knot_shards != world:
            ap.error(f"under {world} processes of torch.distributed.run the "
                     f"tracker takes --ondevice --knot-shards {world}")
        # before the model: this sets the process's card
        initialize_distributed(
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            num_processes=world, process_id=int(os.environ["RANK"]),
            device=device)
    model = iiwa14(torch.float32, device=device)
    if args.grid:
        # 5x5 start/goal grid, skip start == goal != 0 -> 21 pairs
        # (track_iiwa_pcg.cu:30-43)
        traj_names = [f"{ind % 5}_{ind // 5}" for ind in range(25)
                      if not (ind % 5 == ind // 5 and ind % 5 != 0)]
    else:
        traj_names = [args.traj]

    def load_pair(name):
        xu_traj = load_xu_traj(name)
        ee_traj = load_eepos_traj(name)
        if args.steps:
            if args.steps <= args.knots:
                ap.error(f"--steps ({args.steps}) must exceed --knots ({args.knots})")
            xu_traj, ee_traj = xu_traj[: args.steps], ee_traj[: args.steps]
        return xu_traj, ee_traj

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)

    if args.ondevice:
        xu_traj, ee_traj = load_pair(traj_names[0])
        mesh_kw = {}
        if args.knot_shards:
            mesh = make_host_aligned_mesh() if world > 1 \
                else make_mesh(1, args.knot_shards)
            mesh_kw = dict(knot_mesh=mesh, pcg_method="pipelined_slab")
        for tol in args.tols or [1e-5]:
            kw = dict(sqp_cfg=SQPConfig(max_iter=2, max_time_us=None),
                      pcg_cfg=PCGConfig(max_iter=PCGConfig.tuned_max_iter(args.knots),
                                        exit_tol=tol,
                                        exit_criterion=args.exit_criterion,
                                        forcing=args.forcing),
                      linsys=args.linsys, **mesh_kw)
            # the first run builds the kernels; the second is timed
            simulate_mpc_ondevice(model, xu_traj, ee_traj, args.knots, 1.0 / 64.0, **kw)
            sync()
            t0 = time.perf_counter()
            dev = simulate_mpc_ondevice(model, xu_traj, ee_traj, args.knots,
                                        1.0 / 64.0, **kw)
            sync()
            wall = time.perf_counter() - t0
            steps = int(dev["control_updates"])
            errs = dev["tracking_errors"].cpu().numpy()
            if world > 1 and int(os.environ["RANK"]) != 0:
                continue
            print(f"tol={tol}: {steps} control steps in {wall:.3f}s "
                  f"({1e6 * wall / steps:.0f} us/step), "
                  f"avg_tracking_error={float(errs.mean()):.5f}, "
                  f"final={float(dev['final_tracking_error']):.5f}")
        if world > 1:
            torch.distributed.destroy_process_group()
        return

    tols = args.tols or TOL_SWEEP.get(args.knots, DEFAULT_TOLS)
    print(f"knots={args.knots} solver=PCG device={device} pairs={traj_names} "
          f"max_iter={PCGConfig.tuned_max_iter(args.knots)} tols={tols}")
    rows = []
    for name in traj_names:
        xu_traj, ee_traj = load_pair(name)
        if args.grid:
            print(f"start/goal pair {name}: {len(xu_traj)} steps")
        for tol in tols:
            for it in range(args.test_iters):
                stats = simulate_mpc(
                    model, xu_traj, ee_traj,
                    knot_points=args.knots,
                    timestep=1.0 / 64.0,
                    sqp_cfg=SQPConfig(),
                    pcg_cfg=PCGConfig(max_iter=PCGConfig.tuned_max_iter(args.knots),
                                      exit_tol=tol,
                                      exit_criterion=args.exit_criterion,
                                      forcing=args.forcing),
                    sim_cfg=SimConfig(remove_jitters=args.remove_jitters,
                                      live_print_path=args.live_print_path),
                    linsys=args.linsys,
                    verbose=args.verbose,
                )
                s = stats.summary()
                s["exit_tol"] = tol
                s["traj"] = name
                rows.append(s)
                print(f"{name} tol={tol:g}: {s}")
                print_stats(stats.sqp_times_us, "sqp solve time (us)")
                if args.save:
                    dump_tracking_data(
                        args.outdir, f"pcg_{args.knots}_{name}_{tol:g}", stats, it)
    if args.save:
        write_overall_stats_csv(f"{args.outdir}/pcg_{args.knots}_overall_stats.csv", rows)
    return rows


if __name__ == "__main__":
    main()
