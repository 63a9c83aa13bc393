#!/usr/bin/env python3
"""The host-bound loops of the port, timed for an A/B of two source trees.

For the tree given (its package and its chip_smoke.py helpers), on one card:
the main path's on-device loop (N = 64, trace 0_0 rows [:200], slope over
48 and 144 updates), the fleet (B = 256, N = 64, from row 350, unsharded
and over make_mesh(n_instance=4), slope over 16 and 48 updates), the
knot-sharded loop (N = 512 over KnotMesh(8), ca_slab, trace 3_4, slope over
16 and 48 updates), each by CUDA events, median of 3 slopes; and the host
time of one K1 wrapper call (N = 64) enqueued 2000 times in a row, median
of 5.  Prints one JSON line.

    python3 tools/torch_port_loop_ab.py TREE
    python3 tools/torch_port_loop_ab.py --turns PARENT_TREE

``--turns`` runs PARENT_TREE, this tree, this tree, PARENT_TREE, one
process each, and prints each reading beside the others.  Needs a CUDA
card; imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SimConfig, SQPConfig
    from mpcgpu_tpu_torch.models import iiwa14
    from mpcgpu_tpu_torch.parallel import KnotMesh, make_mesh
    from mpcgpu_tpu_torch.sim.mpc import (simulate_mpc_ondevice,
                                          simulate_mpc_ondevice_batched)
    from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur
    from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    model = iiwa14(torch.float32, device=dev)
    out = {}
    pcg = lambda N: PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)
    sqp = SQPConfig(max_iter=2, max_time_us=None)
    xu, ee = load_xu_traj("0_0"), load_eepos_traj("0_0")
    out["main_loop_update_us"] = cs.slope_us(torch, lambda k: simulate_mpc_ondevice(
        model, xu[:200], ee[:200], 64, cs.DT, sqp_cfg=sqp, pcg_cfg=pcg(64),
        sim_cfg=SimConfig(max_control_updates=k)), 48, 144)
    calm = slice(cs.CALM_ROW, cs.CALM_ROW + cs.LOOP_ROWS)
    for name, mesh in (("fleet_update_us", None),
                       ("fleet_instance_axis_update_us", 4)):
        out[name] = cs.slope_us(torch, lambda k: simulate_mpc_ondevice_batched(
            model, xu[calm], ee[calm], 64, cs.DT, 256, sqp_cfg=SQPConfig(max_iter=2),
            pcg_cfg=pcg(64), sim_cfg=SimConfig(max_control_updates=k),
            instance_mesh=mesh and make_mesh(n_instance=mesh)), 16, 48)
    xu3, ee3 = load_xu_traj("3_4")[:512 + cs.LOOP_ROWS], load_eepos_traj("3_4")[:512 + cs.LOOP_ROWS]
    out["sharded_512_8_ca_slab_update_us"] = cs.slope_us(
        torch, lambda k: simulate_mpc_ondevice(
            model, xu3, ee3, 512, cs.DT, sqp_cfg=sqp, pcg_cfg=pcg(512),
            sim_cfg=SimConfig(max_control_updates=k), knot_mesh=KnotMesh(8),
            pcg_method="ca_slab"), 16, 48)
    x, xs, g, _ = cs.problem(64, torch, dev)
    rho = torch.full((), cs.RHO0, device=dev)
    cost = CostConfig.for_knots(64)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            build_kkt_schur(model, cost, x, xs, g, rho, cs.DT, 0)
        host.append((time.perf_counter() - t0) * 1e6 / 2000)
        torch.cuda.synchronize()
    out["k1_wrapper_host_us"] = (statistics.median(host), host)
    out["card"] = cs.card_line()
    return out


def main() -> int:
    if sys.argv[1:2] == ["--turns"]:
        parent = Path(sys.argv[2]).resolve()
        rows = []
        for tree in (parent, HERE, HERE, parent):
            res = subprocess.run([sys.executable, __file__, str(tree)], check=True,
                                 capture_output=True, text=True)
            rows.append((tree, json.loads(res.stdout.strip().splitlines()[-1])))
            print(f"{tree}: {res.stdout.strip().splitlines()[-1]}", flush=True)
        for key in rows[0][1]:
            if key != "card":
                print(f"{key}: " + " / ".join(f"{r[key][0]:.1f}" for _, r in rows)
                      + "  (parent / change / change / parent)")
        return 0
    print(json.dumps(measure(Path(sys.argv[1]).resolve())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
