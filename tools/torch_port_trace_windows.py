#!/usr/bin/env python3
"""Where trace 0_0 gives a Schur system that f32 PCR can solve.

Prints, for the trajectory files the loaders resolve (the port's and the JAX
package's, which may differ: the JAX loader prefers a reference checkout's
recorded traces when one is present), the rows where the trace's joint speeds
or torques run away, and for windows of N knots from a given row the
condition number of the f64 Schur system, and over 10 numpy noise seeds the
true residual max|S x - b| and distance to the f64 solve of the f32 PCR
solves (the port's plain version and the JAX function, one refinement
pass) and of the capped stair PCG (167 iterations, exit 1e-5), with the
count of seeds where PCR's residual is below PCG's (the criterion of
tests/test_pcr.py).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/torch_port_trace_windows.py \
        [--windows 0:64 350:64 0:16] [--seeds 10]

About 2 minutes on the CPU.
"""

import argparse
import statistics

import numpy as np

DT, RHO, SIGMA = 1.0 / 64.0, 1e-3, 0.01


def runaway_rows(xu: np.ndarray, speed: float = 20.0, torque: float = 320.0):
    """(first, last) row intervals where max|qd| > speed or max|u| > torque."""
    bad = (np.abs(xu[:, 7:14]).max(1) > speed) | (np.abs(xu[:, 14:]).max(1) > torque)
    runs, start = [], None
    for i, b in enumerate(bad):
        if b and start is None:
            start = i
        if not b and start is not None:
            runs.append((start, i - 1))
            start = None
    if start is not None:
        runs.append((start, len(bad) - 1))
    return runs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", nargs="+", default=["0:64", "350:64", "0:16"],
                    help="start:knots")
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    from mpcgpu_tpu.ops import pcr as jpcr
    from mpcgpu_tpu.utils import trajfiles as jtraj
    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig
    from mpcgpu_tpu_torch.models import iiwa14
    from mpcgpu_tpu_torch.ops.btd import btd_matvec, btd_to_dense
    from mpcgpu_tpu_torch.ops.ldl import btd_ldl_solve
    from mpcgpu_tpu_torch.ops.pcg import pcg_solve
    from mpcgpu_tpu_torch.ops.pcr import pcr_solve_refined
    from mpcgpu_tpu_torch.ops.schur import form_schur_system
    from mpcgpu_tpu_torch.solver.kkt import build_kkt
    from mpcgpu_tpu_torch.utils import trajfiles

    print(f"port loader: {trajfiles._find('0_0_traj.csv')}")
    print(f"JAX loader:  {jtraj._find('0_0_traj.csv')}")
    X, E = trajfiles.load_xu_traj("0_0"), trajfiles.load_eepos_traj("0_0")
    for a, b in runaway_rows(X):
        print(f"rows {a}-{b}: max|qd| {np.abs(X[a:b + 1, 7:14]).max():.4g} rad/s, "
              f"max|u| {np.abs(X[a:b + 1, 14:]).max():.4g} Nm")

    m64, m32 = iiwa14(torch.float64, device="cpu"), iiwa14(torch.float32, device="cpu")
    for w in args.windows:
        start, N = map(int, w.split(":"))
        rows = slice(start, start + N)
        cost = CostConfig.for_knots(N)
        ee = torch.tensor(E[rows])
        xu0 = X[rows]
        d = btd_to_dense(form_schur_system(build_kkt(
            m64, cost, torch.tensor(xu0), torch.tensor(xu0[0, :14]), ee, DT), RHO).S).numpy()
        ev = np.linalg.eigvalsh((d + d.T) / 2)
        print(f"rows {start}-{start + N - 1}, N={N}: max|qd| "
              f"{np.abs(xu0[:, 7:14]).max():.4g}, max|u| {np.abs(xu0[:, 14:]).max():.4g}, "
              f"cond(S) {ev.max() / ev.min():.4g} (no noise, f64)")
        stats = {k: [] for k in ("port", "jax", "pcg", "port r0", "port r2")}
        dist = {k: [] for k in ("port", "jax", "pcg")}
        for seed in range(args.seeds):
            xu = xu0 + SIGMA * np.random.default_rng(seed).standard_normal(xu0.shape)
            xu = torch.tensor(xu, dtype=torch.float32)
            sch = form_schur_system(build_kkt(m32, cost, xu, xu[0, :14],
                                              ee.float(), DT), RHO)
            S, g = sch.S, sch.gamma
            x64 = btd_ldl_solve(S.double(), g.double())
            res = lambda x: float((btd_matvec(S.double(), x.double()) - g.double()).abs().max())
            far = lambda x: float((x.double() - x64).abs().max() / x64.abs().max())
            xs = {"port": pcr_solve_refined(S, g),
                  "jax": torch.tensor(np.asarray(jpcr.pcr_solve_refined(
                      jnp.asarray(S.numpy()), jnp.asarray(g.numpy()), refine=1))),
                  "pcg": pcg_solve(S, sch.Pinv, g, torch.zeros_like(g),
                                   max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5).lam}
            for k, x in xs.items():
                stats[k].append(res(x))
                dist[k].append(far(x))
            stats["port r0"].append(res(pcr_solve_refined(S, g, refine=0)))
            stats["port r2"].append(res(pcr_solve_refined(S, g, refine=2)))
        med = {k: statistics.median(v) for k, v in stats.items()}
        below = sum(a < b for a, b in zip(stats["port"], stats["pcg"]))
        below_j = sum(a < b for a, b in zip(stats["jax"], stats["pcg"]))
        print(f"  {args.seeds} seeds, medians: residual PCR port {med['port']:.4g} "
              f"(0/1/2 passes {med['port r0']:.4g} / {med['port']:.4g} / "
              f"{med['port r2']:.4g}), PCR JAX {med['jax']:.4g}, capped PCG "
              f"{med['pcg']:.4g}; PCR below PCG in {below} (port) / {below_j} (JAX) "
              f"seeds; distance to f64 / max|x|: port "
              f"{statistics.median(dist['port']):.4g}, JAX "
              f"{statistics.median(dist['jax']):.4g}, PCG {statistics.median(dist['pcg']):.4g}")


if __name__ == "__main__":
    main()
