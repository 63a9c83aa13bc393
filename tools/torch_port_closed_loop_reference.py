#!/usr/bin/env python3
"""Reference readings for the port's closed-loop check in chip_smoke.py.

Runs the closed loop of chip_smoke.py's phase 4 (IIWA-14, N = 64, trace 0_0
rows [:200], SQPConfig(max_iter=2, max_time_us=None), PCGConfig(167, 1e-5),
constant 2 ms updates) on the CPU through the JAX package (f32 and f64) and
through the port's plain versions (f32), and prints each run's mean tracking
error over all updates and over the first 48 (the split-route window).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/torch_port_closed_loop_reference.py \
        [--updates 400] [--runs jax32 jax64 torch32]

Each run takes ~0.5-1.5 min on one CPU core.
"""

import argparse
import time

import numpy as np

ROWS, N, DT = 200, 64, 1.0 / 64.0


def run(which: str, updates: int) -> np.ndarray:
    if which.startswith("jax"):
        import jax
        import jax.numpy as jnp

        jax.config.update("jax_enable_x64", True)
        from mpcgpu_tpu.config import PCGConfig, SimConfig, SQPConfig
        from mpcgpu_tpu.models import iiwa14
        from mpcgpu_tpu.sim.mpc import simulate_mpc_ondevice
        from mpcgpu_tpu.utils.trajfiles import load_eepos_traj, load_xu_traj

        dtype = jnp.float64 if which == "jax64" else jnp.float32
        model, kw = iiwa14(dtype=dtype), dict(linsys="pcg", dtype=dtype)
    else:
        import torch

        torch.set_num_threads(1)
        from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
        from mpcgpu_tpu_torch.models import iiwa14
        from mpcgpu_tpu_torch.sim.mpc import simulate_mpc_ondevice
        from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

        model, kw = iiwa14(torch.float32, device="cpu"), dict(linsys="pcg")
    out = simulate_mpc_ondevice(
        model, load_xu_traj("0_0")[:ROWS], load_eepos_traj("0_0")[:ROWS], N, DT,
        sqp_cfg=SQPConfig(max_iter=2, max_time_us=None),
        pcg_cfg=PCGConfig(max_iter=167, exit_tol=1e-5),
        sim_cfg=SimConfig(max_control_updates=updates), **kw)
    return np.asarray(out["tracking_errors"], dtype=np.float64), out["control_updates"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--updates", type=int, default=400)
    ap.add_argument("--runs", nargs="*", default=["jax32", "jax64", "torch32"])
    args = ap.parse_args()
    for which in args.runs:
        t0 = time.perf_counter()
        errs, updates = run(which, args.updates)
        first = errs[: 48 * len(errs) // updates]
        print(f"{which}: {updates} updates, {len(errs)} shifts, mean tracking "
              f"error {errs.mean():.6g}, first 48 updates {first.mean():.6g} "
              f"({len(first)} shifts), max {errs.max():.6g} "
              f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
