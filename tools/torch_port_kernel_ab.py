#!/usr/bin/env python3
"""Device times of K2, K2', K4, K8b and K4b for one source tree.

    python3 tools/torch_port_kernel_ab.py TREE

TREE is the root of a checkout (this one: ``.``; an earlier commit unpacked
with ``git archive <commit> | tar -x -C devscratch/parent``).  The script
imports that tree's ``mpcgpu_tpu_torch`` and ``chip_smoke``, builds its
kernels (into TREE's own ``_build/<hash>``) and prints one line: each
kernel's device time (a CUDA graph of 20 calls, ``chip_smoke.graph_ms``)
at the main path's shapes: K2 / K2' at N = 64 on the real Schur system
from a cold start (PCG cap 167, exit_tol 1e-5), K4 one 2 ms period at a
2 ms offset, K8b / K4b at B = 256.  To compare two trees on one card, run
them in turns in one chip call (parent, change, change, parent):

    for t in devscratch/parent . . devscratch/parent; do
        python3 tools/torch_port_kernel_ab.py $t; done

``--cluster-sweep`` (a tree with the cluster K2) also times K2' at N = 64
launched by hand with clusters of 2, 4, 8 and 16 CTAs, the choice that
``ops/pcg_cuda.py::k2_cluster_plan`` fixes at 8.

Needs a CUDA card; imports nothing of JAX.
"""

import sys
from pathlib import Path


def main():
    args = [a for a in sys.argv[1:] if a != "--cluster-sweep"]
    tree = Path(args[0] if args else ".").resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as c
    from mpcgpu_tpu_torch.config import CostConfig
    from mpcgpu_tpu_torch.models import iiwa14
    from mpcgpu_tpu_torch.ops.pcg_cuda import pcg_dz_solve, pcg_solve_cuda
    from mpcgpu_tpu_torch.parallel.batched_cuda import (build_kkt_schur_batched,
                                                        pcg_solve_batched)
    from mpcgpu_tpu_torch.sim.plant_cuda import (simulate_plant,
                                                 simulate_plant_batched)
    from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur

    if not torch.cuda.is_available():
        sys.exit("torch_port_kernel_ab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    N, B = c.N_MAIN, c.B_MAIN
    cost = CostConfig.for_knots(N)
    m = iiwa14(torch.float32, device=dev)
    xu, xs, ee, _ = c.problem(N, torch, dev)
    rho = torch.full((), c.RHO0, device=dev)
    s = build_kkt_schur(m, cost, xu, xs, ee, rho, c.DT, 0)
    lam = torch.zeros_like(s["gamma"])
    kw = dict(max_iter=167, exit_tol=1e-5)
    k2 = c.graph_ms(torch, lambda: pcg_dz_solve(s, lam, xu[:, 14:], rho,
                                                cost.r_cost, **kw))
    k2p = c.graph_ms(torch, lambda: pcg_solve_cuda(s["S"], s["Pinv"],
                                                   s["gamma"], lam, **kw))
    it = int(pcg_dz_solve(s, lam, xu[:, 14:], rho, cost.r_cost, **kw)[2])
    xs4 = xs + 0.01 * torch.tensor(np.random.default_rng(1).standard_normal(14),
                                   dtype=torch.float32, device=dev)
    k4 = c.graph_ms(torch, lambda: simulate_plant(m, xs4, xu, 2e-3, 2e-3, c.DT,
                                                  10, 2e-4))
    xu_b, xs_b, ee_b, rho_b = c.batch_problem(B, N, torch, dev)
    sb = build_kkt_schur_batched(m, cost, xu_b, xs_b, ee_b, rho_b, c.DT)
    l0 = torch.zeros((B, N, 14), device=dev)
    k8b = c.graph_ms(torch, lambda: pcg_solve_batched(
        sb["S"], sb["Pinv"], sb["gamma"], l0, **kw), calls=5)
    itb = pcg_solve_batched(sb["S"], sb["Pinv"], sb["gamma"], l0, **kw)[1]
    k4b = c.graph_ms(torch, lambda: simulate_plant_batched(
        m, xs_b, xu_b, 2e-3, 2e-3, c.DT, 10, 2e-4))
    print(f"{tree.name or tree}: K2 {k2 * 1e3:.1f} us ({it} iterations, "
          f"{k2 * 1e3 / max(it, 1):.3f} us each), K2' {k2p * 1e3:.1f} us, K4 "
          f"{k4 * 1e3:.1f} us, K8b {k8b * 1e3:.1f} us (B={B}, iterations "
          f"{int(itb.min())}..{int(itb.max())}, {int(itb.sum())} in all), K4b "
          f"{k4b * 1e3:.1f} us; {c.card_line()}", flush=True)
    if "--cluster-sweep" in sys.argv:
        from mpcgpu_tpu_torch import _kernels
        from mpcgpu_tpu_torch.ops.pcg_cuda import k2_smem_bytes

        launch = _kernels.entry("pcg_dz.cu", "pcg_launch")
        tol = torch.full((), 1e-5, device=dev)
        out = torch.empty_like(lam)
        flags = torch.empty(2, dtype=torch.int32, device=dev)
        for C in (2, 4, 8, 16):
            kp = -(-N // C)

            def k2p_at(C=C, kp=kp):
                _kernels.check(launch(
                    s["S"].data_ptr(), s["Pinv"].data_ptr(), s["gamma"].data_ptr(),
                    lam.data_ptr(), 167, tol.data_ptr(), 0, N, C, kp,
                    k2_smem_bytes(kp), 1, out.data_ptr(), flags.data_ptr(),
                    flags.data_ptr() + 4, _kernels.stream_ptr(dev)), "pcg_launch")

            ms = c.graph_ms(torch, k2p_at)
            print(f"  K2' N={N}, {C} CTAs x {kp} knots: {ms * 1e3:.1f} us, "
                  f"{ms * 1e3 / max(int(flags[0]), 1):.3f} us per CG iteration",
                  flush=True)


if __name__ == "__main__":
    main()
