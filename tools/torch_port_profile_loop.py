#!/usr/bin/env python3
"""Where the port's closed loop spends its time on the card.

Runs chip_smoke.py's closed loop (IIWA-14, N = 64, f32, trace 0_0 rows
[:200], SQPConfig(max_iter=2, max_time_us=None), PCGConfig(167, 1e-5))
once to warm up, then traces ``--updates`` control updates with
torch.profiler and prints: wall time per update, device kernel time per
update by kernel name, the device's busy share, the kernel launches and the
host-side CUDA calls that wait for the device, and the PCG iterations of
the traced solves.  ``--knots`` / ``--knot-shards`` / ``--traj`` /
``--start`` run another horizon, knot-sharded over a virtual mesh on the
card (phase 4d of chip_smoke.py: ``--knots 512 --knot-shards 8 --traj
3_4``), from rows start .. start + N + 136 of the trace, with the tuned
PCG cap of N; ``--pcg-method`` picks the sharded PCG (``ca_slab``: the
s-step kernels).  ``--batch B`` traces the batched loop instead
(``simulate_mpc_ondevice_batched``, B instances; phase 4e: ``--batch 256
--start 350``).  ``--chain`` traces ``--updates`` steps of chip_smoke.py's
warm-started chain instead (phase 3: ``run_chain``, SQPConfig(max_iter=1),
the noisy trace ``chip_smoke.problem`` makes).  ``--split-dz`` runs the
single-device loop on its ``fused_dz=False`` route (K1 -> K2' -> K6).

    python3 tools/torch_port_profile_loop.py [--updates 48] [--trace out.json]
        [--knots 64] [--knot-shards 0] [--pcg-method pipelined] [--batch 0]
        [--traj 0_0] [--start 0] [--chain] [--split-dz] [--top 15]

Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import collections
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--updates", type=int, default=48)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    ap.add_argument("--knots", type=int, default=64)
    ap.add_argument("--knot-shards", type=int, default=0,
                    help="run every solve knot-sharded over this many shards")
    ap.add_argument("--pcg-method", default="pipelined",
                    help="the knot-sharded PCG method (simulate_mpc_ondevice)")
    ap.add_argument("--batch", type=int, default=0,
                    help="trace the batched loop over this many instances")
    ap.add_argument("--traj", default="0_0")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--chain", action="store_true",
                    help="trace the warm-started chain (one SQP iteration a step)")
    ap.add_argument("--top", type=int, default=15,
                    help="print this many kernels by device time")
    ap.add_argument("--split-dz", action="store_true",
                    help="the fused_dz=False route (K2' then K6)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("torch_port_profile_loop: needs a CUDA device")
    from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
    from mpcgpu_tpu_torch.models import iiwa14
    from mpcgpu_tpu_torch.parallel import KnotMesh
    from mpcgpu_tpu_torch.sim.mpc import (simulate_mpc_ondevice,
                                          simulate_mpc_ondevice_batched)
    from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

    model = iiwa14(torch.float32)
    N, rows = args.knots, slice(args.start, args.start + args.knots + 136)
    xu, ee = load_xu_traj(args.traj)[rows], load_eepos_traj(args.traj)[rows]
    cap = PCGConfig.tuned_max_iter(N)
    mesh = dict(knot_mesh=KnotMesh(args.knot_shards),
                pcg_method=args.pcg_method) if args.knot_shards else {}
    if args.split_dz:
        mesh["fused_dz"] = False
    kw = dict(sqp_cfg=SQPConfig(max_iter=2, max_time_us=None),
              pcg_cfg=PCGConfig(max_iter=cap, exit_tol=1e-5),
              sim_cfg=SimConfig(max_control_updates=args.updates))

    if args.chain:
        import chip_smoke
        from mpcgpu_tpu_torch.config import CostConfig
        from mpcgpu_tpu_torch.sim.mpc import run_chain

        dev = torch.device("cuda", 0)
        cmodel = iiwa14(torch.float32, device=dev)
        cxu, cxs, _, cee = chip_smoke.problem(N, torch, dev)
        clam = torch.zeros((N, 14), dtype=torch.float32, device=dev)

    def loop():
        if args.chain:
            return run_chain(cmodel, CostConfig.for_knots(N),
                             SQPConfig(max_iter=1), kw["pcg_cfg"], cxu, clam,
                             cxs, cee, chip_smoke.RHO0, chip_smoke.DT,
                             args.updates, linsys="pcg_cuda", merit_impl="cuda")
        if args.batch:
            return simulate_mpc_ondevice_batched(model, xu, ee, N, 1.0 / 64.0,
                                                 args.batch, **kw)
        return simulate_mpc_ondevice(model, xu, ee, N, 1.0 / 64.0, **mesh, **kw)

    loop()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = loop()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n = args.updates
    device = collections.Counter()
    calls = collections.Counter()
    launches = 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        if ev.key.startswith(("cuda", "aten::item", "aten::_local_scalar")):
            calls[ev.key] = ev.count
        if dev_us and ev.device_type.name == "CUDA":
            device[ev.key] += dev_us
            launches += ev.count
    busy = sum(device.values())
    what = "chain steps" if args.chain else "updates"
    print(f"{torch.cuda.get_device_name(0)}; {n} {what}, wall {wall_us / n:.1f} "
          f"us each (under the profiler), device kernel time {busy / n:.1f} "
          f"us each, busy share {100 * busy / wall_us:.1f}%, "
          f"{launches / n:.1f} kernel launches each")
    for key, us in device.most_common(args.top):
        print(f"  {us / n:10.2f} us/update {100 * us / busy:6.2f}%  {key[:90]}")
    for key in sorted(calls):
        print(f"  host call {key}: {calls[key]} ({calls[key] / n:.2f} per update)")
    if args.chain:
        iters = out.pcg_iters.cpu().double()
        print(f"PCG iterations per step: mean {float(iters.mean()):.2f}, at the "
              f"cap {int((iters == cap).sum())} of {iters.numel()}")
    elif not args.batch:
        iters = out["pcg_iters"].cpu()
        used = iters[iters >= 0].double()
        print(f"PCG iterations per solve: mean {float(used.mean()):.2f}, at the "
              f"cap {int((used == cap).sum())} of {used.numel()}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
