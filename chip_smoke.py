#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mpcgpu_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  1. print the card's name and power limit; build the CUDA kernels from
     mpcgpu_tpu_torch/csrc with nvcc and print the build time;
  2. hold each kernel (K1 KKT+Schur, K2 PCG+dz, K3 line-search merits, K4
     plant, K5 KKT blocks, K2' PCG without the dz epilogue, K6 dz) against
     its plain PyTorch version on the card, at N = 64 and N = 512;
  3. run the warm-started chain: 64 MPC steps of the IIWA-14 at N = 64 in
     f32 through the kernels (linsys="pcg_cuda"), check the results and that
     every kernel was launched, compare step 1 with the plain and f64 steps,
     and hold K2 to the plain version at the chain's first exit before the
     PCG cap;
  4. run the closed-loop tracker at N = 64 (trace 0_0, 400 control updates)
     on the device at constant frequency (the main path, K1-K4), against
     the host loop (bit for bit), the device loop at adaptive frequency
     with a calibrated solve time (against the constant-frequency loop at
     that period), eight runs from traces moved by one f32 ulp (the spread
     that sets the tracking bands) and all plain on the card; then 48
     updates through the split routes (fused=False: K5 -> K2';
     fused_dz=False: K1 -> K2' -> K6) and fused=False's first solve against
     the plain and f64 solves; check launches, finiteness and tracking
     errors;
  5. time the chain per step and the on-device loop per control update
     (slopes over two lengths, CUDA events), and each kernel (device time
     of a CUDA graph) against its plain version at N = 64;
  6. print one JSON line of kernel results, the card line, and the final
     {"ok": true, ...} line.

Without a CUDA device it exits at once with a non-zero code.  It imports
nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_MAIN = 64
N_BIG = 512
DT = 1.0 / 64.0
RHO0 = 1e-3
CHAIN_STEPS = 64
SLOPE_STEPS = (16, 48)
REAL_SEEDS = 10
LOOP_ROWS = 200          # rows of trace 0_0 the closed loop tracks
LOOP_UPDATES = 400       # control updates of the closed loop
ROUTE_UPDATES = 48       # control updates of each split-route run
ROUTE_SHIFTS = 6         # the shifts those updates make (one per 8 updates)
LOOP_ENSEMBLE = 8        # runs of the main path from 1-ulp trace changes
LOOP_SLOPE = (48, 144)   # two loop lengths for the per-update slope
# plant windows (time offset, sim time) in s: tests/test_mpc.py's three and
# one across the knot boundary at 1/64 s
PLANT_WINDOWS = ((0.0, 5e-4), (2e-3, 2e-3), (1.3e-2, 1.3e-3), (1.5e-2, 2e-3))

# kernel name -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "K1 build_kkt_schur": (
        "mpcgpu_tpu_torch/csrc/kkt_schur.cu",
        "mpcgpu_tpu/solver/kkt_pallas.py:829 build_kkt_schur_pallas"),
    "K2 pcg_dz_solve": (
        "mpcgpu_tpu_torch/csrc/pcg_dz.cu",
        "mpcgpu_tpu/ops/pcg_pallas.py:160 pcg_dz_solve_pallas_lanes"),
    "K3 line_search_merits_fused": (
        "mpcgpu_tpu_torch/csrc/merit.cu",
        "mpcgpu_tpu/solver/merit_pallas.py:277 line_search_merits_pallas"),
    "K4 simulate_plant": (
        "mpcgpu_tpu_torch/csrc/plant.cu",
        "mpcgpu_tpu/sim/plant_pallas.py:132 simulate_plant_pallas"),
    "K5 build_kkt_cuda": (
        "mpcgpu_tpu_torch/csrc/kkt_schur.cu",
        "mpcgpu_tpu/solver/kkt_pallas.py:566 build_kkt_pallas"),
    "K2' pcg_solve_cuda": (
        "mpcgpu_tpu_torch/csrc/pcg_dz.cu",
        "mpcgpu_tpu/ops/pcg_pallas.py:429 pcg_solve_pallas_lanes"),
    "K6 compute_dz_cuda": (
        "mpcgpu_tpu_torch/csrc/pcg_dz.cu",
        "mpcgpu_tpu/solver/kkt_pallas.py:990 compute_dz_pallas"),
}

# The least time the card could take for each kernel's work: the larger of
# its floating-point operations over the f32 peak outside the tensor cores
# and its bytes (each input read once, each output written once) over the
# memory rate (H100 SXM data sheet, at 700 W).  Operation counts are per
# knot or per iteration of the algorithm, counted from its products:
#   mv6 (6x6 by 6) 72, a 6x6 product 432, mm4 128 FLOP;
#   RNEA_DUAL: per link 4 mv6 forward, 3 more for I v, I a and their
#     tangents, 3 crf products (~30 each), 2 mv6t backward: ~780 -> 7 links;
#   ABA: per link 2 mv6 + crf forward, Ia and two 6x6 products backward,
#     one mv6 in the last pass: ~1200 -> 7 links;
#   FK: 6 mm4 and 7 affine 4x4 transforms;
#   K5 per knot: 15 RNEA_DUAL (bias + 14 tangents), CRBA (6 pairs of 6x6
#     products), Gauss-Jordan 7x14, M^-1 dID (7x7x14), FK with 7 tangents;
#   K1 per knot: K5 + A Qinv and T (2 x 14^3 + 14^2 x 7 x 2), the Schur
#     block's Gauss-Jordan 14x28 and the stair bands (4 x 14^3);
#   K2 per iteration: two BTD matvecs (2 x 3 x 14^2 x 2 per knot), two dots
#     and three axpys over 14 per knot; the dz recovery ~1000 per knot.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
MV6, M66, MM4 = 72, 432, 128
RNEA_DUAL = 7 * (7 * MV6 + 3 * 30 + 2 * MV6)
ABA = 7 * (2 * MV6 + 30) + 6 * (72 + 2 * M66 + 2 * MV6) + 7 * MV6
FK = 6 * MM4 + 7 * 48
KKT_KNOT = 15 * RNEA_DUAL + 6 * 2 * M66 + 7 * 7 * 14 * 2 + 7 * 7 * 14 * 2 + 7 * FK
SCHUR_KNOT = 2 * 14 ** 3 * 2 + 14 * 14 * 7 * 2 + 14 * 14 * 28 * 2 + 4 * 14 ** 3 * 2
PCG_ITER_KNOT = 2 * 3 * 196 * 2 + 2 * 2 * 14 + 3 * 2 * 14
DZ_KNOT = 1000


def bound(flops: float, floats: float) -> tuple[float, str]:
    """(least time in ms, "operations" or "bytes") for f32 work."""
    t_ops, t_bytes = flops / PEAK_F32, 4 * floats / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def kernel_bounds(N: int, k2_iters: int, k2p_iters: int, plant_rows: int,
                  plant_substeps: int, num_cand: int = 9) -> dict:
    """Each kernel's (bound_ms, bound_by) at N knots, from this run's
    iteration counts and the plan rows the plant window reads."""
    model = 1344                 # the packed model; K4 reads its first 1008
    dyn = 4 * 7 * 36             # floats only (X matrices and inertias)
    kkt_out = N * (196 + 14 + 14) + (N - 1) * (196 + 98)
    k1_out = N * (2 * 3 * 196 + 14 + 196 + 196 + 98 + 14)
    pcg_in = N * (2 * 3 * 196 + 14 + 14)
    dz_in = N * (196 + 196 + 98 + 14 + 7)
    return {
        "K1 build_kkt_schur": bound(N * (KKT_KNOT + SCHUR_KNOT),
                                    N * (21 + 3) + model + 1 + k1_out),
        "K2 pcg_dz_solve": bound(N * (PCG_ITER_KNOT * (k2_iters + 1) + DZ_KNOT),
                                 pcg_in + dz_in + 1 + N * (14 + 21) + 2),
        "K3 line_search_merits_fused": bound(num_cand * N * (ABA + FK + 150),
                                             2 * N * 21 + 14 + 3 * N + model
                                             + 2 * num_cand),
        "K4 simulate_plant": bound(plant_substeps * (ABA + 14 * 20 + 28),
                                   14 + 7 * plant_rows + dyn + 3 + 14),
        "K5 build_kkt_cuda": bound(N * KKT_KNOT, N * (21 + 3) + 14 + model + kkt_out),
        "K2' pcg_solve_cuda": bound(N * PCG_ITER_KNOT * (k2p_iters + 1),
                                    pcg_in + N * 14 + 2),
        "K6 compute_dz_cuda": bound(N * DZ_KNOT, N * 14 + dz_in + 1 + N * 21),
    }


class SmokeFailure(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def problem(N: int, torch, device, seed: int = 0):
    """Trace 0_0 plus numpy noise (sigma 0.01; seed 0 as bench.py sets up
    its chain); f32 tensors on the card."""
    import numpy as np

    from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

    xu = load_xu_traj("0_0")[:N]
    xu = xu + 0.01 * np.random.default_rng(seed).standard_normal(xu.shape)
    ee_full = load_eepos_traj("0_0")
    f = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)
    return f(xu), f(xu[0, :14]), f(ee_full[:N]), f(ee_full)


def synthetic_btd(N: int, torch, device, seed: int = 1):
    """A well-conditioned SPD block-tridiagonal system for K2 (f32 S, Pinv,
    gamma; eigenvalues of S in [0.77, 9.4] at N = 64): diagonal blocks
    R R^T / 14 + 3.5 I, off-diagonal blocks 0.3 N(0, 1), the stair
    preconditioner D^-1 - D^-1 T D^-1 of them, gamma N(0, 1).  On it f32
    rounding stays near 1e-7 over 20 CG steps, so the kernel is held to the
    plain version tightly; on the real Schur system rounding dominates."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = 14
    R = rng.standard_normal((N, n, n))
    diag = R @ R.transpose(0, 2, 1) / n + 3.5 * np.eye(n)
    low = 0.3 * rng.standard_normal((N - 1, n, n))          # block (k+1, k)
    S = np.zeros((N, 3, n, n))
    S[:, 1], S[1:, 0], S[:-1, 2] = diag, low, low.transpose(0, 2, 1)
    D = np.linalg.inv(diag)
    P = np.zeros_like(S)
    P[:, 1] = D
    P[1:, 0] = -D[1:] @ S[1:, 0] @ D[:-1]
    P[:-1, 2] = -D[:-1] @ S[:-1, 2] @ D[1:]
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return f(S), f(P), f(rng.standard_normal((N, n)))


def part_errs(got, ref, nx: int = 14) -> dict:
    """max|got - ref| / max|ref|, over the state columns (:nx) and, where
    there are more, over the control columns (nx:) separately."""
    got, ref = got.double().cpu(), ref.double().cpu()
    d = (got - ref).abs()
    r = ref.abs()
    out = {"x": float(d[:, :nx].max() / r[:, :nx].max().clamp(min=1e-30))}
    if ref.shape[-1] > nx:
        out["u"] = float(d[:, nx:].max() / r[:, nx:].max().clamp(min=1e-30))
    return out


def parts(got, ref) -> dict:
    """K2 results (lam, dz, ...) compared per part: lam, and dz's state and
    control columns, each as max|got - ref| / max|ref| of that part."""
    dz = part_errs(got[1], ref[1])
    return {"lam": part_errs(got[0], ref[0])["x"], "dz x": dz["x"], "dz u": dz["u"]}


def fmt(e: dict) -> str:
    return ", ".join(f"{k} {v:.3e}" for k, v in e.items())


def time_ms(torch, fn, reps: int) -> float:
    """Median device time of one call of fn, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(torch, fn, calls: int = 20, reps: int = 5) -> float:
    """Median device time of one call of fn: `calls` calls captured in one
    CUDA graph, replayed `reps` times between CUDA events.  For a kernel
    shorter than the host's enqueue of its launches, an event pair around
    one call measures the host instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|)."""
    d = float((got.double() - ref.double()).abs().max())
    s = float(ref.double().abs().max())
    return d, d / max(s, 1e-30)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "mpcgpu_tpu_torch").is_dir():
        print(f"chip_smoke: no mpcgpu_tpu_torch package beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SimConfig, SQPConfig
    from mpcgpu_tpu_torch import _kernels
    from mpcgpu_tpu_torch.models import iiwa14
    from mpcgpu_tpu_torch.ops.btd import btd_matvec
    from mpcgpu_tpu_torch.ops.pcg import pcg_solve
    from mpcgpu_tpu_torch.ops.pcg_cuda import (compute_dz_cuda, compute_dz_plain,
                                               pcg_dz_solve, pcg_dz_solve_plain,
                                               pcg_solve_cuda)
    from mpcgpu_tpu_torch.sim.mpc import (run_chain, simulate_mpc,
                                          simulate_mpc_ondevice)
    from mpcgpu_tpu_torch.sim.plant_cuda import simulate_plant, simulate_plant_plain
    from mpcgpu_tpu_torch.solver.kkt import build_kkt
    from mpcgpu_tpu_torch.solver.sqp import sqp_solve
    from mpcgpu_tpu_torch.solver.kkt_cuda import (build_kkt_cuda, build_kkt_schur,
                                                  build_kkt_schur_plain)
    from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merits_fused,
                                                    line_search_merits_plain)
    from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

    # each kernel's wrapper, whose .launches counts its launches
    wrappers = dict(zip(KERNELS, (build_kkt_schur, pcg_dz_solve,
                                  line_search_merits_fused, simulate_plant,
                                  build_kkt_cuda, pcg_solve_cuda,
                                  compute_dz_cuda)))

    def counted(fn, *args, **kw):
        """fn(*args, **kw) with every launch count set to 0 just before it;
        returns (result, the counts just after)."""
        for w in wrappers.values():
            w.launches = 0
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, {name: w.launches for name, w in wrappers.items()}

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    _kernels.libraries()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for src, log in _kernels.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    model = iiwa14(torch.float32, device=dev)
    mu = SQPConfig().mu
    errs = {name: 0.0 for name in KERNELS}
    failures = []

    def expect(ok: bool, msg: str):
        print(("  ok   " if ok else "  FAIL ") + msg)
        if not ok:
            failures.append(msg)

    # ---- phase 2: kernels against their plain versions --------------------
    print("phase 2: kernels vs plain versions on the card")
    for N in (N_MAIN, N_BIG):
        cost = CostConfig.for_knots(N)
        xu, xs, ee, _ = problem(N, torch, dev)
        rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
        for integ in (0, 1):
            got = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, integ)
            ref = build_kkt_schur_plain(model, cost, xu, xs, ee, rho, DT, integ)
            torch.cuda.synchronize()
            for key in ("S", "Pinv", "gamma", "Qinv", "A", "B", "q"):
                d, r = rel_err(got[key], ref[key])
                if N == N_MAIN:
                    errs["K1 build_kkt_schur"] = max(errs["K1 build_kkt_schur"], d)
                expect(r <= 5e-5, f"K1 N={N} integrator={integ} {key}: "
                       f"max|d|={d:.3e} = {r:.3e} max|ref| (<= 5e-5)")
        lam0 = torch.zeros((N, 14), dtype=torch.float32, device=dev)
        u = xu[:, 14:]
        k2 = lambda s_, **kw: (pcg_dz_solve(s_, lam0, u, rho, cost.r_cost, **kw),
                               pcg_dz_solve_plain(s_, lam0, u, rho, cost.r_cost, **kw))

        # K2 on a well-conditioned system (synthetic_btd, with K1's blocks
        # for the dz epilogue): f32 rounding stays near 1e-7 there (<= 2.7e-7
        # kernel vs plain, every part), so both are held to 2e-6 per part,
        # and the exit fires before the cap by either criterion.
        syn = dict(build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0))
        syn["S"], syn["Pinv"], syn["gamma"] = synthetic_btd(N, torch, dev)
        for crit, tol, cap in (("eta", 0.0, 20), ("eta", 1e-9, 167),
                               ("rnorm", 1e-5, 167)):
            got, ref = k2(syn, max_iter=cap, exit_tol=tol, exit_criterion=crit)
            e = parts(got, ref)
            ik, ip = int(got[2]), int(ref[2])
            case = f"K2 N={N} well-conditioned {crit} exit_tol={tol:g} cap={cap}"
            # K2' is K2's template with the epilogue compiled out: the same
            # exit, and lam bit for bit; against its plain version (the
            # plain K2's PCG, pcg_solve) as K2 is held
            k2p = pcg_solve_cuda(syn["S"], syn["Pinv"], syn["gamma"], lam0,
                                 max_iter=cap, exit_tol=tol, exit_criterion=crit)
            torch.cuda.synchronize()
            ep = part_errs(k2p.lam, ref[0])["x"]
            if N == N_MAIN:
                errs["K2' pcg_solve_cuda"] = max(errs["K2' pcg_solve_cuda"],
                                                 rel_err(k2p.lam, ref[0])[0])
            expect(torch.equal(k2p.lam, got[0]) and int(k2p.iters) == ik
                   and bool(k2p.converged) == bool(got[3]) and ep <= 2e-6,
                   f"K2' {case[3:]}: lam bitwise equal to K2's "
                   f"{torch.equal(k2p.lam, got[0])}, iters {int(k2p.iters)} "
                   f"(K2 {ik}), vs plain lam {ep:.3e} (<= 2e-6)")
            expect(max(e.values()) <= 2e-6, f"{case}: {fmt(e)} (<= 2e-6)")
            if tol == 0.0:
                expect(ik == ip == cap, f"{case}: steps kernel {ik}, plain {ip} (= {cap})")
            else:
                expect(abs(ik - ip) <= 2 and ik < cap and bool(got[3]) and bool(ref[3]),
                       f"{case}: iters kernel {ik}, plain {ip} (differ by <= 2, "
                       f"< cap); converged kernel {bool(got[3])}, plain {bool(ref[3])}")

        # K2 on the real Schur system, fixed step counts (exit_tol=0), over
        # REAL_SEEDS noise seeds (seed 0 is the main path's).  Here f32
        # rounding of S p decides the last digits: S has entries up to 9e8
        # and kappa = |p|^T |S| |p| / p^T S p is ~3.4e4, so alpha = eta /
        # p.Sp, and lam = alpha p after one step, carry a relative error of
        # order u32 kappa ~ 2e-3 in any f32 summation order; which order
        # lands closer to f64 changes from seed to seed (the kernel / plain
        # ratio of that distance spans 0.3..14 over the seeds).  So in each
        # seed, one step is held within u32 kappa of an f64 run, and both
        # step counts are held to the plain version on the card within
        # bounds per part (~1.4x / ~3x the largest kernel-vs-plain reading
        # over the seeds).  Over the seeds, the kernel's median distance to
        # f64 per part is held within 2x the plain version's (readings
        # <= 1.6x, in PERF.md).
        u32 = 2.0 ** -24
        cpu = torch.device("cpu")
        dist = {steps: {w: {key: [] for key in ("lam", "dz x", "dz u")}
                        for w in ("kernel", "plain", "plain cpu")}
                for steps in (1, 20)}
        for seed in range(REAL_SEEDS):
            xu_s, xs_s, ee_s, _ = problem(N, torch, dev, seed)
            sys_ = build_kkt_schur(model, cost, xu_s, xs_s, ee_s, rho, DT, 0)
            sys64 = {k: v.double() for k, v in sys_.items()}
            u_s = xu_s[:, 14:]
            p64 = btd_matvec(sys64["Pinv"], sys64["gamma"])
            kappa = float((p64.abs() * btd_matvec(sys64["S"].abs(), p64.abs())).sum()
                          / (p64 * btd_matvec(sys64["S"], p64)).sum())
            for steps, bound in ((1, {"lam": 1e-3, "dz x": 1e-3, "dz u": 1e-3}),
                                 (20, {"lam": 2e-2, "dz x": 2e-1, "dz u": 1e-2})):
                kw = dict(max_iter=steps, exit_tol=0.0)
                got = pcg_dz_solve(sys_, lam0, u_s, rho, cost.r_cost, **kw)
                ref = pcg_dz_solve_plain(sys_, lam0, u_s, rho, cost.r_cost, **kw)
                ref_cpu = pcg_dz_solve_plain({k: v.to(cpu) for k, v in sys_.items()},
                                             lam0.cpu(), u_s.cpu(), rho.cpu(),
                                             cost.r_cost, **kw)
                f64 = pcg_dz_solve_plain(sys64, lam0.double(), u_s.double(),
                                         rho.double(), cost.r_cost, **kw)
                if N == N_MAIN:
                    errs["K2 pcg_dz_solve"] = max(
                        errs["K2 pcg_dz_solve"], rel_err(got[0], ref[0])[0],
                        rel_err(got[1], ref[1])[0])
                e = parts(got, ref)
                for w, res_ in (("kernel", got), ("plain", ref), ("plain cpu", ref_cpu)):
                    for key, v in parts(res_, f64).items():
                        dist[steps][w][key].append(v)
                ek = parts(got, f64)
                ok = all(e[key] <= bound[key] for key in e)
                rule = ""
                if steps == 1:
                    ok = ok and max(ek.values()) <= u32 * kappa
                    rule = (f"; to f64 {fmt(ek)} (<= u32 kappa = "
                            f"{u32 * kappa:.2e}, kappa {kappa:.4g})")
                expect(ok and int(got[2]) == steps and int(ref[2]) == steps,
                       f"K2 N={N} real system seed {seed}, {steps} fixed steps: vs "
                       f"plain {fmt(e)} (<= {fmt(bound)}){rule}; steps kernel "
                       f"{int(got[2])}, plain {int(ref[2])} (= {steps})")
        for steps, d in dist.items():
            for key in d["kernel"]:
                med = {w: statistics.median(v[key]) for w, v in d.items()}
                closer = sum(a < b for a, b in zip(d["kernel"][key], d["plain"][key]))
                expect(med["kernel"] <= 2 * med["plain"],
                       f"K2 N={N} real system, {steps} fixed steps, {key}: median "
                       f"distance to f64 over {REAL_SEEDS} seeds kernel "
                       f"{med['kernel']:.3e}, plain card {med['plain']:.3e}, plain "
                       f"cpu {med['plain cpu']:.3e} (kernel <= 2x plain card); "
                       f"kernel closer in {closer}/{REAL_SEEDS}")
        sys_ = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0)
        # The main path's settings from a cold start: both sides run to the
        # cap here (the exit is held on the synthetic system above and at
        # the main path's first early exit in phase 3).
        got, ref = k2(sys_, max_iter=167, exit_tol=1e-5)
        ik, ip = int(got[2]), int(ref[2])
        expect(abs(ik - ip) <= 2, f"K2 N={N} real system, exit_tol=1e-5 cap=167: "
               f"iters kernel {ik}, plain {ip} (differ by <= 2)")
        dz = got[1]
        m_got, a_got = line_search_merits_fused(model, cost, xu, dz, xs, ee, mu, DT)
        m_ref, a_ref = line_search_merits_plain(model, cost, xu, dz, xs, ee, mu, DT)
        torch.cuda.synchronize()
        rel = float(((m_got.double() - m_ref.double()).abs()
                     / m_ref.double().abs()).max())
        if N == N_MAIN:
            errs["K3 line_search_merits_fused"] = float(
                (m_got.double() - m_ref.double()).abs().max())
        expect(rel <= 1e-4 and torch.equal(a_got, a_ref),
               f"K3 N={N}: merits max relative error {rel:.3e} (<= 1e-4), "
               f"alphas equal {torch.equal(a_got, a_ref)}")

        # K6 on K1's blocks with K2's lam: against its plain version, and
        # bit for bit against K2's fused dz (the same device functions)
        d6 = compute_dz_cuda(sys_, got[0], u, rho, cost.r_cost)
        p6 = compute_dz_plain(sys_, got[0], u, rho, cost.r_cost)
        torch.cuda.synchronize()
        d, r = rel_err(d6, p6)
        if N == N_MAIN:
            errs["K6 compute_dz_cuda"] = d
        expect(r <= 1e-5 and torch.equal(d6, got[1]),
               f"K6 N={N}: vs plain compute_dz max|d|={d:.3e} = {r:.3e} "
               f"max|ref| (<= 1e-5); bitwise equal to K2's fused dz "
               f"{torch.equal(d6, got[1])}")

        # K5 against build_kkt per output (K1 reaches <= 1.8e-5 max|ref|);
        # the second case takes the semi-implicit integrator, the angle wrap
        # and the reference's x_{N-2} terminal cost
        for integ, wrap in ((0, False), (1, True)):
            c5 = cost if integ == 0 else dataclasses.replace(
                cost, terminal_at_last_state=False)
            got5 = build_kkt_cuda(model, c5, xu, xs, ee, DT, integ, wrap)
            ref5 = build_kkt(model, c5, xu, xs, ee, DT, integ, wrap)
            torch.cuda.synchronize()
            for key in ("Q", "q", "A", "B", "c", "R", "r"):
                d, r = rel_err(getattr(got5, key), getattr(ref5, key))
                if N == N_MAIN:
                    errs["K5 build_kkt_cuda"] = max(errs["K5 build_kkt_cuda"], d)
                expect(r <= 5e-5, f"K5 N={N} integrator={integ} wrap={wrap} "
                       f"{key}: max|d|={d:.3e} = {r:.3e} max|ref| (<= 5e-5)")

        # K4 over the windows of tests/test_mpc.py (all inside knot 0) and
        # one that crosses into knot 1, from a perturbed state; the plain
        # version's ABA rounds in another order, but its qdd error times a
        # 2e-4 s substep is below one f32 ulp of the state (<= 1e-6 max|x|)
        xs4 = xs + 0.01 * torch.tensor(np.random.default_rng(1).standard_normal(14),
                                       dtype=torch.float32, device=dev)
        for t_off, sim_t in PLANT_WINDOWS:
            a4 = simulate_plant(model, xs4, xu, t_off, sim_t, DT, 10, 2e-4)
            b4 = simulate_plant_plain(model, xs4, xu, t_off, sim_t, DT, 10, 2e-4)
            torch.cuda.synchronize()
            d, r = rel_err(a4, b4)
            moved = float((b4 - xs4).abs().max())
            if N == N_MAIN:
                errs["K4 simulate_plant"] = max(errs["K4 simulate_plant"], d)
            expect(r <= 1e-6 and moved > 0.0,
                   f"K4 N={N} window t_off={t_off:g} s, {sim_t:g} s: max|d|="
                   f"{d:.3e} = {r:.3e} max|x| (<= 1e-6); the state moved by "
                   f"{moved:.3e}")
        # the clip schedule integrates exactly: one 2 ms window and two 1 ms
        # windows take the same substeps, so the kernel's states are equal
        a1 = simulate_plant(model, xs4, xu, 0.0, 1e-3, DT, 10, 2e-4)
        a2 = simulate_plant(model, a1, xu, 1e-3, 1e-3, DT, 10, 2e-4)
        a4 = simulate_plant(model, xs4, xu, 0.0, 2e-3, DT, 10, 2e-4)
        torch.cuda.synchronize()
        expect(torch.equal(a4, a2), f"K4 N={N}: one 2 ms window == two 1 ms "
               f"windows bit for bit ({torch.equal(a4, a2)}, max|d| "
               f"{float((a4 - a2).abs().max()):.3e})")
    if failures:
        raise SmokeFailure(f"phase 2: {len(failures)} check(s) failed")

    # ---- phase 3: the main path -------------------------------------------
    print(f"phase 3: the chain, {CHAIN_STEPS} warm-started steps, N={N_MAIN}")
    N = N_MAIN
    cost = CostConfig.for_knots(N)
    sqp_cfg = SQPConfig(max_iter=1)
    pcg_cfg = PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)
    xu, xs, _, ee_full = problem(N, torch, dev)
    lam = torch.zeros((N, 14), dtype=torch.float32, device=dev)

    def chain(linsys, steps):
        # the plain chain stays plain: merit_impl="auto" would take K3 there
        return run_chain(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_full,
                         RHO0, DT, steps, linsys=linsys,
                         merit_impl="cuda" if linsys == "pcg_cuda" else "plain")

    res, n = counted(chain, "pcg_cuda", CHAIN_STEPS)
    print(f"  launches in the chain: {n}")
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (res.step_xu, res.merit, res.xu, res.lam, res.rho))
    expect(finite, "chain: every result finite")
    for name in list(KERNELS)[:3]:
        expect(n[name] >= CHAIN_STEPS,
               f"chain: {name} launched {n[name]} times (>= {CHAIN_STEPS})")
    plain = chain("pcg", CHAIN_STEPS)
    torch.cuda.synchronize()
    accepted = int((res.ls_alpha_idx >= 0).sum())
    expect(accepted > CHAIN_STEPS // 2 and float(res.merit[-1]) < float(res.merit[0]),
           f"main path: line search accepted {accepted}/{CHAIN_STEPS} steps (> half); "
           f"merit {float(res.merit[0]):.6g} -> {float(res.merit[-1]):.6g}")
    cap = pcg_cfg.max_iter
    iters_k, iters_p = res.pcg_iters.tolist(), plain.pcg_iters.tolist()
    print(f"  PCG iterations per step, kernels: {iters_k}")
    print(f"  PCG iterations per step, plain:   {iters_p}")

    # Step 1 runs PCG to its cap on the ill-conditioned real system, where
    # f32 rounding decides the step (phase 2): every f32 run, plain or
    # kernel, on the card or the CPU, lies 0.69-0.78 max|x| from the f64
    # step in the state columns and 2.6e-2..2.8e-2 max|u| in the control
    # columns, and two plain f32 runs differ by 0.48 max|x| and 2.1e-3
    # max|u|.  So the control part is held within 1e-2 max|u| of the plain
    # f32 step; the state part carries no digits of the f64 step in f32 and
    # is held only to its scale (2 max|x|).  Each part of the kernels' step
    # lies no farther from the f64 step than 1.5x the plain f32 steps do.
    m64 = iiwa14(torch.float64, device=dev)
    m_cpu = iiwa14(torch.float32, device="cpu")
    step1 = lambda m, t: sqp_solve(m, cost, sqp_cfg, pcg_cfg, t(xu), t(lam), t(xs),
                                   t(ee_full[:N]), RHO0, DT, linsys="pcg",
                                   merit_impl="plain").xu
    ref64 = step1(m64, lambda a: a.double())
    ref_cpu = step1(m_cpu, lambda a: a.cpu())
    e = part_errs(res.step_xu[0], plain.step_xu[0])
    ek = part_errs(res.step_xu[0], ref64)
    ep, ec = part_errs(plain.step_xu[0], ref64), part_errs(ref_cpu, ref64)
    for key, bound in (("x", 2.0), ("u", 1e-2)):
        expect(e[key] <= bound and ek[key] <= 1.5 * max(ep[key], ec[key]),
               f"step 1 xu {key} part, kernels vs plain: {e[key]:.3e} max|{key}| "
               f"(<= {bound:g}); to f64: kernels {ek[key]:.3e}, plain card "
               f"{ep[key]:.3e}, plain cpu {ec[key]:.3e} (kernels <= 1.5x max(plain))")

    # The chains part at step 1 and never meet again, so their iteration
    # counts differ.  The kernel chain's first step that exited before the
    # cap is rebuilt (the chain is deterministic) and K2 is held there to
    # the plain version in f32 and f64: the same exit on a real state.
    early = [i for i, n in enumerate(iters_k) if n < cap]
    if early:
        j = early[0]
        st = chain("pcg_cuda", j)
        sj = build_kkt_schur(model, cost, st.xu, st.xs, st.ee_goal, st.rho, DT, 0)
        args = (st.lam, st.xu[:, 14:], st.rho, cost.r_cost)
        kw = dict(max_iter=cap, exit_tol=pcg_cfg.exit_tol)
        got = pcg_dz_solve(sj, *args, **kw)
        ref = pcg_dz_solve_plain(sj, *args, **kw)
        f64 = pcg_dz_solve_plain({k: v.double() for k, v in sj.items()},
                                 *(a.double() for a in args[:3]), args[3], **kw)
        ik, ip, i64 = int(got[2]), int(ref[2]), int(f64[2])
        expect(ik == iters_k[j] and abs(ik - ip) <= 2 and abs(ik - i64) <= 2
               and bool(got[3]) and bool(ref[3]),
               f"K2 at chain step {j + 1} (first exit before the cap): iters "
               f"in the chain {iters_k[j]}, kernel {ik}, plain {ip}, f64 {i64} "
               f"(differ by <= 2); converged kernel {bool(got[3])}, plain "
               f"{bool(ref[3])}")
    else:
        print("  no chain step exited before the cap")
    it_k = float(res.pcg_iters.double().mean())
    it_p = float(plain.pcg_iters.double().mean())
    print(f"  mean PCG iterations per step: kernels {it_k:.2f}, plain {it_p:.2f}")
    print(f"  line-search accepted: kernels {accepted}, plain "
          f"{int((plain.ls_alpha_idx >= 0).sum())} of {CHAIN_STEPS}")
    if failures:
        raise SmokeFailure(f"phase 3: {len(failures)} check(s) failed")

    # ---- phase 4: the closed loop --------------------------------------------
    print(f"phase 4: closed loop, N={N_MAIN}, trace 0_0[:{LOOP_ROWS}], "
          f"{LOOP_UPDATES} control updates")
    xu_traj = load_xu_traj("0_0")[:LOOP_ROWS]
    ee_traj = load_eepos_traj("0_0")[:LOOP_ROWS]
    loop_kw = dict(sqp_cfg=SQPConfig(max_iter=2, max_time_us=None),
                   pcg_cfg=PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5))

    def loop(updates, const=True, xu=None, sim=None, **kw):
        sim = SimConfig(max_control_updates=updates, const_update_freq=const,
                        **(sim or {}))
        return simulate_mpc_ondevice(model, xu_traj if xu is None else xu,
                                     ee_traj, N, DT, sim_cfg=sim, **loop_kw, **kw)

    def finite(*ts):
        return all(bool(torch.isfinite(torch.as_tensor(t)).all()) for t in ts)

    k1_k3 = list(KERNELS)[:3]
    # the main path: the on-device loop at constant frequency, K1-K4
    main_run, n_main = counted(loop, LOOP_UPDATES)
    updates = main_run["control_updates"]
    solves = int(main_run["sqp_iters"].sum())
    print(f"  on-device (const): launches {n_main}; {updates} updates, "
          f"{solves} SQP iterations")
    expect(updates == LOOP_UPDATES and n_main["K4 simulate_plant"] == updates,
           f"main path: K4 launched {n_main['K4 simulate_plant']} times, once per "
           f"control update ({updates})")
    expect(all(n_main[k] == solves for k in k1_k3),
           f"main path: K1-K3 launched {[n_main[k] for k in k1_k3]} times, once "
           f"per SQP iteration ({solves})")
    expect(finite(main_run["tracking_errors"], main_run["xs_path"],
                  main_run["final_tracking_error"]),
           "main path: tracking errors and states finite")
    err_dev = main_run["tracking_errors"].double().cpu().numpy()

    host, n_host = counted(simulate_mpc, model, xu_traj, ee_traj, N, DT,
                           sim_cfg=SimConfig(max_control_updates=LOOP_UPDATES),
                           **loop_kw)
    hs = host.summary()
    err_host = np.asarray(host.tracking_errors)
    # tests/test_mpc.py::test_ondevice_sim_matches_host_loop's behavioural
    # tolerance; both loops run the same kernels on the same inputs in the
    # same order, so they are expected to agree to the bit
    same_len = len(err_host) == len(err_dev)
    gap = float(np.abs(err_host - err_dev).max()) if same_len else float("inf")
    expect(same_len and bool(np.all(np.abs(err_host - err_dev)
                                    <= 5e-3 + 0.1 * np.abs(err_host)))
           and abs(host.final_tracking_error - float(main_run["final_tracking_error"]))
           <= 5e-3 + 0.1 * abs(host.final_tracking_error),
           f"host loop vs on-device: {len(err_host)} / {len(err_dev)} tracking "
           f"errors, max|d| {gap:.3e} (rtol 0.1, atol 5e-3); bitwise equal "
           f"{same_len and bool(np.array_equal(err_host, err_dev))}")
    expect(n_host["K4 simulate_plant"] == LOOP_UPDATES and finite(err_host)
           and all(n_host[k] >= sum(host.sqp_iters) for k in k1_k3),
           f"host loop: launches {n_host}; SQP iterations {sum(host.sqp_iters)}; "
           f"avg_sqp_time_us {hs['avg_sqp_time_us']:.1f}")

    # the adaptive loop with a calibrated solve time: every solve here takes
    # max_iter SQP iterations, so each update's modelled solve time is
    # max_iter * per_iter_us, and the loop must equal the constant-frequency
    # loop at that period (the same plant windows and shifts; the clocks
    # differ only in rounding, f32 on the card against f64 on the host,
    # far from any shift threshold)
    ada, n_ada = counted(loop, LOOP_UPDATES, const=False)
    sim_t, it_a = ada["sim_times_us"].double().cpu(), ada["sqp_iters"].double().cpu()
    max_it = loop_kw["sqp_cfg"].max_iter
    expect(ada["control_updates"] > 0 and len(ada["tracking_errors"]) >= 3
           and finite(ada["tracking_errors"], ada["xs_path"])
           and bool(torch.allclose(sim_t, ada["per_iter_us"] * it_a, rtol=1e-5))
           and bool((it_a == max_it).all())
           and n_ada["K4 simulate_plant"] >= ada["control_updates"],
           f"on-device (adaptive): per_iter_us {ada['per_iter_us']:.1f} "
           f"(calibrated), {ada['control_updates']} updates, "
           f"{len(ada['tracking_errors'])} shifts, SQP iterations per update "
           f"{sorted(set(it_a.int().tolist()))} (all {max_it}), launches {n_ada}")
    const_a = loop(LOOP_UPDATES, sim=dict(
        simulation_period_us=max_it * ada["per_iter_us"]))
    err_a = ada["tracking_errors"].double().cpu().numpy()
    print(f"  mean tracking error: on-device {err_dev.mean():.6g}, host "
          f"{err_host.mean():.6g}, adaptive {err_a.mean():.6g}")
    err_c = const_a["tracking_errors"].double().cpu().numpy()
    same_len = len(err_a) == len(err_c)
    expect(same_len and bool(np.all(np.abs(err_a - err_c) <= 5e-3 + 0.1 * np.abs(err_c))),
           f"adaptive vs constant frequency at {max_it} x per_iter_us: "
           f"{len(err_a)} / {len(err_c)} tracking errors (rtol 0.1, atol 5e-3); "
           f"bitwise equal {same_len and bool(np.array_equal(err_a, err_c))}")

    # f32 closed loops part chaotically: every solve runs PCG to its cap on
    # an ill-conditioned system, so rounding decides its last digits and
    # the loops that round differently drift apart from the first shift.
    # The yardstick is therefore the spread of the main path itself under
    # rounding-sized changes: LOOP_ENSEMBLE runs from traces moved by one
    # f32 ulp per entry.  Another route passes when its mean tracking error
    # lies in the ensemble's range (main run included) widened on each side
    # by the range's own ratio hi/lo (the errors are positive and spread by
    # factors: 0.34-0.79 over 400 updates, 0.0065-0.018 over the first 6
    # shifts on an H100); over 48 updates it also stays under
    # tests/test_mpc.py's tracking bar of 0.12.
    rng = np.random.default_rng(2)
    ens_400, ens_48 = [err_dev.mean()], [err_dev[:ROUTE_SHIFTS].mean()]
    xu32 = xu_traj.astype(np.float32)
    for _ in range(LOOP_ENSEMBLE):
        way = np.where(rng.random(xu32.shape) < 0.5, -np.inf, np.inf).astype(np.float32)
        run = loop(LOOP_UPDATES, xu=np.nextafter(xu32, way).astype(np.float64))
        e = run["tracking_errors"].double().cpu().numpy()
        ens_400.append(e.mean())
        ens_48.append(e[:ROUTE_SHIFTS].mean())

    def band(ens):
        lo, hi = min(ens), max(ens)
        return lo * lo / hi, hi * hi / lo

    band_400, band_48 = band(ens_400), band(ens_48)
    print(f"  main path under 1-ulp trace changes ({LOOP_ENSEMBLE} runs + the "
          f"main run): mean tracking error over {LOOP_UPDATES} updates "
          f"{min(ens_400):.6g}..{max(ens_400):.6g} (band {band_400[0]:.6g}.."
          f"{band_400[1]:.6g}); over the first {ROUTE_SHIFTS} shifts "
          f"{min(ens_48):.6g}..{max(ens_48):.6g} (band {band_48[0]:.6g}.."
          f"{band_48[1]:.6g})")

    # all plain on the card, the whole loop: the independent yardstick
    plain_loop, n_plain = counted(loop, LOOP_UPDATES, linsys="pcg", merit_impl="plain")
    err_p = plain_loop["tracking_errors"].double().cpu().numpy()
    expect(all(n_plain[k] == 0 for k in KERNELS if k != "K4 simulate_plant")
           and n_plain["K4 simulate_plant"] == LOOP_UPDATES and finite(err_p)
           and band_400[0] <= err_p.mean() <= band_400[1]
           and band_48[0] <= err_p[:ROUTE_SHIFTS].mean() <= band_48[1]
           and err_p[:ROUTE_SHIFTS].mean() < 0.12,
           f"route plain ({LOOP_UPDATES} updates): launches {n_plain} (K4 only); "
           f"mean tracking error {err_p.mean():.6g} (in {band_400[0]:.6g}.."
           f"{band_400[1]:.6g}), over the first {ROUTE_SHIFTS} shifts "
           f"{err_p[:ROUTE_SHIFTS].mean():.6g} (in {band_48[0]:.6g}.."
           f"{band_48[1]:.6g}, < 0.12)")

    # the split routes, ROUTE_UPDATES updates each
    routes = {"fused=False": dict(fused=False), "fused_dz=False": dict(fused_dz=False)}
    route_runs, route_n = {}, {}
    for name, kw in routes.items():
        route_runs[name], route_n[name] = counted(loop, ROUTE_UPDATES, **kw)
    want = {"fused=False": ("K5 build_kkt_cuda", "K2' pcg_solve_cuda",
                            "K3 line_search_merits_fused"),
            "fused_dz=False": ("K1 build_kkt_schur", "K2' pcg_solve_cuda",
                               "K6 compute_dz_cuda", "K3 line_search_merits_fused")}
    for name, used in want.items():
        n_r, run = route_n[name], route_runs[name]
        it_r = int(run["sqp_iters"].sum())
        m = float(run["tracking_errors"].double().mean())
        ok = all(n_r[k] == (it_r if k in used else 0)
                 for k in KERNELS if k != "K4 simulate_plant")
        ok = ok and n_r["K4 simulate_plant"] == ROUTE_UPDATES
        ok = ok and len(run["tracking_errors"]) == ROUTE_SHIFTS
        ok = ok and finite(run["tracking_errors"])
        ok = ok and band_48[0] <= m <= band_48[1] and m < 0.12
        expect(ok, f"route {name}: launches {n_r} (kernels {list(used)} once per "
               f"SQP iteration, {it_r}; K4 once per update); mean tracking "
               f"error over {ROUTE_SHIFTS} shifts {m:.6g} (in {band_48[0]:.6g}.."
               f"{band_48[1]:.6g}, < 0.12)")
    same = torch.equal(route_runs["fused_dz=False"]["xs_path"],
                       main_run["xs_path"][:ROUTE_UPDATES])
    expect(same, f"route fused_dz=False == the main path bit for bit over "
           f"{ROUTE_UPDATES} updates (K2' lam and K6 dz equal K2's): {same}")

    # fused=False's first solve on the loop's first state, per part, as
    # phase 3 holds step 1: the control part within 1e-2 max|u| of the
    # plain route's, each part no farther from the f64 solve than 1.5x the
    # plain f32 solves (card and CPU)
    xu_l0 = torch.tensor(xu_traj[:N], dtype=torch.float32, device=dev)
    ee_l0 = torch.tensor(ee_traj[:N], dtype=torch.float32, device=dev)

    def first_solve(m, t, **kw):
        return sqp_solve(m, cost, SQPConfig(max_iter=1), loop_kw["pcg_cfg"],
                         t(xu_l0), t(torch.zeros_like(xu_l0[:, :14])),
                         t(xu_l0[0, :14]), t(ee_l0), RHO0, DT, **kw).xu

    plain_kw = dict(linsys="pcg", merit_impl="plain")
    got = first_solve(model, lambda a: a, linsys="pcg_cuda", fused=False)
    ref = first_solve(model, lambda a: a, **plain_kw)
    ref_cpu = first_solve(m_cpu, lambda a: a.cpu(), **plain_kw)
    ref64 = first_solve(m64, lambda a: a.double(), **plain_kw)
    e = part_errs(got, ref)
    ek, ep, ec = part_errs(got, ref64), part_errs(ref, ref64), part_errs(ref_cpu, ref64)
    for key, bound in (("x", 2.0), ("u", 1e-2)):
        expect(e[key] <= bound and ek[key] <= 1.5 * max(ep[key], ec[key]),
               f"fused=False first solve, {key} part, vs plain: {e[key]:.3e} "
               f"max|{key}| (<= {bound:g}); to f64: fused=False {ek[key]:.3e}, "
               f"plain card {ep[key]:.3e}, plain cpu {ec[key]:.3e} "
               f"(<= 1.5x max(plain))")
    launches = {k: n_main[k] for k in list(KERNELS)[:4]}
    launches["K5 build_kkt_cuda"] = route_n["fused=False"]["K5 build_kkt_cuda"]
    for k in ("K2' pcg_solve_cuda", "K6 compute_dz_cuda"):
        launches[k] = route_n["fused_dz=False"][k]
    if failures:
        raise SmokeFailure(f"phase 4: {len(failures)} check(s) failed")

    # ---- phase 5: timing ----------------------------------------------------
    print(f"phase 5: timing at N={N_MAIN} (CUDA events, medians)")
    lo, hi = SLOPE_STEPS
    slopes, t_lo_all = [], []
    chain("pcg_cuda", lo)
    torch.cuda.synchronize()
    for _ in range(3):
        t = {}
        for k in (lo, hi):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            chain("pcg_cuda", k)
            b.record()
            torch.cuda.synchronize()
            t[k] = a.elapsed_time(b) * 1e3
        slopes.append((t[hi] - t[lo]) / (hi - lo))
        t_lo_all.append(t[lo] / lo)
    step_us = statistics.median(slopes)
    print(f"  chain per-step latency (slope {lo}->{hi} steps): {step_us:.1f} us "
          f"(runs: {', '.join(f'{s:.1f}' for s in slopes)}); "
          f"wall/{lo}: {statistics.median(t_lo_all):.1f} us")
    print(f"  mean PCG iterations per step: {it_k:.2f}")

    # the on-device closed loop per control update: the slope over two loop
    # lengths cancels the per-run set-up (schedule, first solve)
    lo, hi = LOOP_SLOPE
    loop_slopes = []
    loop(lo)
    torch.cuda.synchronize()
    for _ in range(3):
        t = {}
        for k in (lo, hi):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            loop(k)
            b.record()
            torch.cuda.synchronize()
            t[k] = a.elapsed_time(b) * 1e3
        loop_slopes.append((t[hi] - t[lo]) / (hi - lo))
    update_us = statistics.median(loop_slopes)
    print(f"  on-device loop per control update (slope {lo}->{hi} updates, "
          f"{loop_kw['sqp_cfg'].max_iter} SQP iterations each): {update_us:.1f} us "
          f"(runs: {', '.join(f'{s:.1f}' for s in loop_slopes)}); host loop "
          f"avg_sqp_time_us {hs['avg_sqp_time_us']:.1f}")

    xu, xs, ee, _ = problem(N, torch, dev)
    rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
    sys_ = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0)
    lam0 = torch.zeros((N, 14), dtype=torch.float32, device=dev)
    pcg_kw = dict(max_iter=pcg_cfg.max_iter, exit_tol=1e-5)
    lam_k2, dz, k2_iters, _ = pcg_dz_solve(sys_, lam0, xu[:, 14:], rho,
                                           cost.r_cost, **pcg_kw)
    k2p_iters = int(pcg_solve_cuda(sys_["S"], sys_["Pinv"], sys_["gamma"], lam0,
                                   **pcg_kw).iters)
    # the plant as the main path drives it: one 2 ms period at a 2 ms offset
    # from a perturbed state, 10 + 1 substeps of 0.2 ms
    xs4 = xs + 0.01 * torch.tensor(np.random.default_rng(1).standard_normal(14),
                                   dtype=torch.float32, device=dev)
    t_off, period, n_sub = 2e-3, 2e-3, 10
    plant_rows = len({min(int((t_off + i * 2e-4) / DT), N - 1)
                      for i in range(n_sub + 1)})
    bounds = kernel_bounds(N, int(k2_iters), k2p_iters, plant_rows, n_sub + 1)
    pairs = {
        "K1 build_kkt_schur": (
            lambda: build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0),
            lambda: build_kkt_schur_plain(model, cost, xu, xs, ee, rho, DT, 0)),
        "K2 pcg_dz_solve": (
            lambda: pcg_dz_solve(sys_, lam0, xu[:, 14:], rho, cost.r_cost, **pcg_kw),
            lambda: pcg_dz_solve_plain(sys_, lam0, xu[:, 14:], rho, cost.r_cost,
                                       **pcg_kw)),
        "K3 line_search_merits_fused": (
            lambda: line_search_merits_fused(model, cost, xu, dz, xs, ee, mu, DT),
            lambda: line_search_merits_plain(model, cost, xu, dz, xs, ee, mu, DT)),
        "K4 simulate_plant": (
            lambda: simulate_plant(model, xs4, xu, t_off, period, DT, n_sub, 2e-4),
            lambda: simulate_plant_plain(model, xs4, xu, t_off, period, DT, n_sub,
                                         2e-4)),
        "K5 build_kkt_cuda": (
            lambda: build_kkt_cuda(model, cost, xu, xs, ee, DT),
            lambda: build_kkt(model, cost, xu, xs, ee, DT)),
        "K2' pcg_solve_cuda": (
            lambda: pcg_solve_cuda(sys_["S"], sys_["Pinv"], sys_["gamma"], lam0,
                                   **pcg_kw),
            lambda: pcg_solve(sys_["S"], sys_["Pinv"], sys_["gamma"], lam0, **pcg_kw)),
        "K6 compute_dz_cuda": (
            lambda: compute_dz_cuda(sys_, lam_k2, xu[:, 14:], rho, cost.r_cost),
            lambda: compute_dz_plain(sys_, lam_k2, xu[:, 14:], rho, cost.r_cost)),
    }
    print(f"  K2 / K2' at the timed state: {int(k2_iters)} / {k2p_iters} PCG "
          f"iterations; plant window reads {plant_rows} plan row(s)")
    rows = []
    for name, (kern, plain_fn) in pairs.items():
        # plain, kernel, kernel, plain: drift between the two cancels.  The
        # kernel's time is device time (a CUDA graph of 20 calls); one call
        # timed alone, with its host enqueue, is printed beside it.  The
        # plain versions synchronize inside (the PCG once per iteration), so
        # they are timed one call at a time.
        p1 = time_ms(torch, plain_fn, 5)
        k1 = graph_ms(torch, kern)
        k2 = graph_ms(torch, kern)
        p2 = time_ms(torch, plain_fn, 5)
        ms, plain_ms = statistics.median([k1, k2]), statistics.median([p1, p2])
        call_ms = time_ms(torch, kern, 20)
        bound_ms, bound_by = bounds[name]
        print(f"  {name}: kernel {ms * 1e3:.1f} us (device), one call "
              f"{call_ms * 1e3:.1f} us (with enqueue), plain {plain_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.3f} us ({bound_by})")
        src, replaces = KERNELS[name]
        # no single PyTorch call computes any of these functions
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=launches[name], max_abs_err=errs[name],
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None, call_ms=call_ms))

    # ---- phase 6: results -----------------------------------------------
    print(json.dumps({"kernels": rows, "chain_step_us": step_us,
                      "mean_pcg_iters": it_k, "plain_mean_pcg_iters": it_p,
                      "loop_update_us": update_us,
                      "host_avg_sqp_time_us": hs["avg_sqp_time_us"],
                      "loop_mean_tracking_error": float(err_dev.mean()),
                      "adaptive_per_iter_us": ada["per_iter_us"],
                      "card": card}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
