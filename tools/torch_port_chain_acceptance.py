#!/usr/bin/env python3
"""How many of the warm-started chain's line searches accept a step, under
rounding-sized changes of the input.

    python3 tools/torch_port_chain_acceptance.py [--runs 9] [--device cpu]

Runs chip_smoke.py's phase-3 chain (IIWA-14, N = 64, 64 steps,
SQPConfig(max_iter=1), PCGConfig(167, 1e-5), the plain route
``linsys="pcg"``) in f32 from ``chip_smoke.problem``'s trace and from
``--runs - 1`` copies of it moved by one f32 ulp per entry (numpy seeds
1..), then once in f64, and prints the number of accepted steps of each.
Every solve runs PCG to its cap on an ill-conditioned system, so f32
rounding decides each step and the chains part at step 1: the spread of
these counts is how far chip_smoke.py's "line search accepted more than
half the steps" check is decided by rounding.  ~20 s per chain on a CPU.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=9)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as c
    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
    from mpcgpu_tpu_torch.models import iiwa14
    from mpcgpu_tpu_torch.sim.mpc import run_chain

    dev = torch.device(args.device)
    N, steps = c.N_MAIN, c.CHAIN_STEPS
    cost = CostConfig.for_knots(N)
    xu0, _, _, ee0 = c.problem(N, torch, dev)

    def accepted(xu, ee, dtype):
        res = run_chain(iiwa14(dtype, device=dev), cost, SQPConfig(max_iter=1),
                        PCGConfig(max_iter=PCGConfig.tuned_max_iter(N),
                                  exit_tol=1e-5),
                        xu, torch.zeros((N, 14), dtype=dtype, device=dev),
                        xu[0, :14].clone(), ee, c.RHO0, c.DT, steps, linsys="pcg",
                        merit_impl="plain")
        return int((res.ls_alpha_idx >= 0).sum())

    counts = []
    for k in range(args.runs):
        xu = xu0
        if k:
            sign = np.random.default_rng(k).choice([-1.0, 1.0], size=tuple(xu0.shape))
            xu = torch.nextafter(xu0, xu0 + torch.tensor(sign, dtype=xu0.dtype,
                                                         device=dev) * torch.inf)
        counts.append(accepted(xu, ee0, torch.float32))
        print(f"f32, trace moved by one ulp (seed {k})" if k else "f32, the trace",
              f"accepted {counts[-1]}/{steps}", flush=True)
    f64 = accepted(xu0.double(), ee0.double(), torch.float64)
    print(f"f64: accepted {f64}/{steps}; f32 over {args.runs} runs: "
          f"{min(counts)}..{max(counts)}, more than half in "
          f"{sum(n > steps // 2 for n in counts)}/{args.runs}")


if __name__ == "__main__":
    main()
