#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mpcgpu_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  1. print the card's name and power limit; build the CUDA kernels from
     mpcgpu_tpu_torch/csrc with nvcc (every source at nq = 7, the IIWA's,
     and at nq = 3 and 5, all at once) and print the build
     time, each kernel's registers and spills per nq, and the plans of K7
     (one launch per solve), K10b and K10a (a thread-block cluster per
     shard) and the coefficient step (a cluster of CTAs per shard);
  2. hold each kernel of the first two slices (K1 KKT+Schur, K2 PCG+dz, K3
     line-search merits, K4 plant, K5 KKT blocks, K2' PCG without the dz
     epilogue, K6 dz) against its plain PyTorch version on the card, at
     N = 64 and N = 512, and K2 / K2' (one thread-block cluster per solve)
     also at the ragged N = 2, 37, 100; print K2's cluster plan and
     cudaOccupancyMaxActiveClusters at each N; K6 (a warp per knot,
     launched with programmatic dependent launch) also bit for bit against
     the earlier dz_kernel, which K8c still runs;
  2a. hold K1, K2, K3, K4 and K4b at nq = 3 and 5 (the chain tracker's
     planar arms, on their own reference traces) against their plain
     versions at N = 16, 64 and 512, at the tolerances of their nq = 7
     checks (K2 on synthetic_btd at nx = 6, 10 within 2e-6, on the real
     system by medians over 10 seeds);
  2b. hold K7 (PCR) against its plain version and the f64 solve on a
     well-conditioned system (N = 2, 3, 64, 100, 512); on the real Schur
     system over noise seeds, against the capped PCG's residual in every
     seed on the calm rows (N = 64) and by medians against its plain
     version elsewhere (N = 64, 512); hold K8a-c and K3
     over instances (B = 256, N = 64) against the single-instance kernels
     bit for bit per instance (K8c also against dz_kernel at batch = 1),
     and B = 4 instances against the plain versions;
  2c. hold the knot-sharded path's slab kernels (K9a KKT+Schur on the
     halo-extended slabs, K9b dz, K9c merit partials, K10a the pipelined CG
     step) against their plain versions on the card at N = 64 over 4 shards
     and N = 512 over 8, K9a and K9b against K1 and K6 bit for bit on the
     interior rows (K9b also against the earlier dz_kernel), and the sharded PCG through K10a against K2' on the
     well-conditioned system (tightly) and on the real system over noise
     seeds (by medians); check that K9a's corner blocks at the horizon's
     ends are exactly 0; hold K10b (the s-step basis and Gram kernel) and
     the coefficient step against their plain versions on both systems, and
     the s-step PCG through them against the same loop with the plain steps
     and against K2' (well-conditioned: counts within s, both exits before
     the cap) and over noise seeds by medians (real); hold K10b, the
     coefficient step, the s-step PCG and K10a at N = 512 on one shard
     (the plans' largest slabs), one call of K10a and one of the
     coefficient step with some shards exited (their state bit for bit
     unchanged), and the fused sharded SQP's default route on one shard
     against pcg_cuda at N = 508 and N = 512 (K9a's slab of 516 knots);
  2d. hold every other kernel (K5, K2', K6, K7, K8a-c, K3b, K9a-c, K10a,
     K10b, K10b') at nq = 3 and 5 against its plain version, on the chain
     tracker's planar arms and their own traces, with its nq = 7 check's
     tolerance: the single kernels at N = 16-64 (nq = 3) and 64, 512 (nq =
     5), K8a-c and K3b at B = 64, the slab kernels at N = 64 over 4 shards
     and (nq = 5) 512 over 8;
  2e. the race check of K6 and K9b: K1 then K6, and K9a then K9b, 16 pairs
     on fresh blocks in one CUDA graph (outputs NaN before the replay) and
     eagerly, at nq = 3, 5 and 7: every dz bit for bit the earlier
     dz_kernel's on its blocks and within K6's bound of the plain version;
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
     errors; trace one fused_dz=False solve with torch.profiler: every K6
     launch right after a K2' launch;
  4b. run the host loop for 48 updates from the calm row CALM_ROW through
     each direct solver (pcr_cuda: K5 -> K7 -> K3; pcr all plain; ldl;
     qdldl_host) next to pcg_cuda, hold the exact solvers' tracking to
     ldl's and pcr_cuda's to the all-plain pcr loop by eight 1-ulp runs,
     and run the direct-solver tracker script;
  4c. run the batched solve (B = 256, N = 64, 2 SQP iterations) through
     make_batched_sqp_solver, and hold eight instances to their single
     fused solves bit for bit, and sqp_solve_batched_fused_sharded over
     make_mesh(n_instance=4) to the unsharded solve bit for bit;
  4d. run the knot-sharded SQP solve (sqp_solve_sharded, fused: K9a ->
     K10a -> K9b -> K9c) at N = 512 over 8 shards and N = 64 over 4 against
     the single-device pcg_cuda solve and the f64 solve, and 48 knot-sharded
     on-device control updates at both sizes; then the same at the solve's
     default pcg_method ("auto" -> "ca_slab": K9a -> K10b + the coefficient
     step -> K9b -> K9c); check launches, finiteness and tracking;
  4e. the batched closed loop (BASELINE config 3: 256 instances, N = 64,
     trace 0_0 from the calm row, 48 updates) through
     simulate_mpc_ondevice_batched (K8a-c, K3b, K4b), unsharded and over
     instance_mesh=make_mesh(n_instance=4), every instance bit for bit;
     K4b against K4 on all 256 instances bit for bit, and four instances
     against the single on-device loop from the same starts bit for bit;
  4f. the onboarding path (mpcgpu_tpu_torch/track_chain.py): the fused SQP
     on the JAX tests' 3-link problem against the plain f32 and f64 solves;
     the chain tracker at nq = 5, N = 64 over its 240-row trace on the
     device (the whole trace; us per update) and the host loop through
     K1-K4, held to the spread of plain f64 loops from 1-ulp changes of
     the trace; a loop at nq = 3; and the IIWA-14 loaded from its own URDF
     (load_urdf(export_urdf(iiwa14()))) through K1-K4 at N = 64, bit for
     bit where the packed f32 models are equal;
  4g. the other kernels' paths at nq = 5 (N = 64, full size) and 3 (N =
     16): the fleet (B = 256 / 64, 48 / 16 updates, unsharded and over the
     instance axis, four instances against single loops), the knot-sharded
     fused SQP (N = 512 over 8 / 64 over 4, pipelined_slab and ca_slab)
     against the single-device, plain and f64 solves, and the split routes
     and pcr_cuda through the chain tracker's loop (at nq = 5 each route's
     band of runs from 1-ulp trace changes holds its plain f32 loop);
  4h. the last gaps to the JAX package (``gap_checks``): the main-path
     loop of phase 4 at PCGConfig.tuned_max_iter_h100(64) inside phase 4's
     band, with K2's time per call, the loops' mean PCG iterations and us
     per update at both caps; pcg_solve(precond_poly=2) at f64 on the card
     against the dense solve and precond_poly=1; the batched solve's
     merit_impl "plain" against "cuda" (B = 256, one SQP iteration): the
     launches, and the line-search choices equal or tied within the
     merits' own gap;
  4i. the flags of the JAX wrappers (``flag_checks``) on joint angles
     near +-pi, where the integrator's angle wrap fires: K3 at N = 64 with
     include_zero=False and with angle_wrap=True, K9a at 512 / 8 and 64 / 4
     with angle_wrap=True, K9c there with include_zero=False,
     angle_wrap=True and both, each against its plain version with the
     same flags at its phase 2 / 2c bound, each flag shown to change the
     output (the alphas shift by one index, the defects and gamma move),
     K9a's interior rows against K1 with the wrap bit for bit, K9c's
     assembled merits against K3's; each flagged launch's device time
     beside the default launch's, in turns;
  4j. the one-arm fused route's CUDA graph per SQP iteration
     (``graph_checks``): GRAPH_UPDATES updates of the on-device closed loop
     at N = 64 and at N = 512 (K2's 16-CTA cluster) on the K2 and the split
     route, every output bit for bit against the eager body, a result
     unchanged after later solves, us per update of chained solves each way
     at both N and the replay's host us, and K1, K2, K3 by name in a
     profiler trace of replays;
  5. time the chain per step, the on-device loop per control update (the
     main path, pcr_cuda and the knot-sharded loops), the batched solve per
     SQP iteration against 256 single solves, the sharded solve per SQP
     iteration against the single-device one (slopes over two lengths, CUDA
     events) for the pipelined and the s-step PCG, the batched closed loop
     per update, and each kernel (device time of a CUDA graph) against its
     plain version, its bound and, for K7, the dense library solve (K2,
     K2' and K8b also per CG iteration); every kernel also at nq = 3 and 5,
     each beside its bound at that nq; the fleet unsharded and over the
     instance axis, in turns; K6 and K9b beside the earlier dz_kernel and
     without programmatic dependent launch, the empty kernel on their grids
     (the launch floor) and the pairs K2' -> K6 and halo glue -> K9b;
  7. the multi-card path (``multicard_checks``): one worker process per
     visible card, at most four, in one NCCL group on a localhost
     coordinator (this script with ``--multicard-worker``), each finding its
     card through ``initialize_distributed``; one wall limit for all of
     them, and any worker that fails or hangs fails the script.  With one
     visible card, one worker in a world of 1: the sharded SQP through
     every route over the one-process mesh == KnotMesh(1) bit for bit (its
     psum and gather go through NCCL), its loop likewise, and the fleet
     over make_host_aligned_mesh(1).  With four: the knot axis over 2
     cards (N = 64, 512; every pcg_method and route) == KnotMesh(2) bit
     for bit, which with two instance groups is also the 2 x 2 grid (its
     batched solve == make_mesh(2, 2) bit for bit); the knot axis over 4
     cards (N = 512, 64; ca_slab and pipelined_slab) held to pcg_cuda and
     f64 at phase 4d's bounds, every rank the same bits, and its loops
     within phase 4d's band; the fleet over the instance axis (B = 256,
     each card's 64 instances == the one-card loop's bit for bit); the
     launches and collectives per SQP iteration of every path; the times
     of the knot axis beside KnotMesh(4) and pcg_cuda on one card, of the
     fleet beside one card's loop, of one collective of each kind the
     solves issue, and of the card guard;
  6. print one JSON line of kernel results (each row with the nq values its
     kernel was checked at, its nq = 3, 5 numbers and the cards it ran on),
     the card line, and the final {"ok": true, ...} line.

Without a CUDA device it exits at once with a non-zero code.  It imports
nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

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
PCR_SIZES = (2, 3, 64, 100, 512)   # K7 on the well-conditioned system
K2_RAGGED = (2, 37, 100)  # K2 / K2' beside N_MAIN, N_BIG: ragged cluster plans
KKT_RAGGED = (16, 33)     # K1 / K3 beside N_MAIN, N_BIG: ragged windows and rounds
# The bundled trace 0_0 (data/trajfiles, made by tools/make_trajfiles.py)
# runs away to joint speeds of up to 264 rad/s and torques of up to 5335 Nm
# in rows 16-26, and again in rows 103-114, 199-212, 312-326, 428-438, ...
# (tools/torch_port_trace_windows.py).  A Schur system over such rows has
# cond ~1e13, where neither package's f32 PCR keeps a digit.  Rows 350-419
# stay below 1.3 rad/s and 15 Nm (cond 3.5e4 at N = 64): the direct solvers
# are held to the reference's criteria there.
CALM_ROW = 350
B_MAIN = 256             # instances of the batched solve
B_PLAIN = 4              # instances held against the plain versions
BATCH_PICKS = 8          # instances held against their single solves
TRACKER_STEPS = 65       # trace rows of the direct-solver tracker's run
# the knot-sharded path: (N, shards) at full width (L = 64) and beside the
# single-device main path; the first is this slice's main path
SHARD_CASES = ((512, 8), (64, 4))
SHARD_UPDATES = 48       # knot-sharded on-device control updates per case
SHARD_SLOPE = (16, 48)   # loop lengths for the sharded per-update slope
CA_S = 4                 # the s-step PCG's s (the solve's default pcg_s_steps)
CA_CAP = 10 ** 6         # an iteration cap no kernel-vs-plain call reaches
BATCH_UPDATES = 48       # updates of the batched closed loop (phase 4e)
BATCH_LOOP_PICKS = 4     # its instances held against single loops
BATCH_SLOPE = (16, 48)   # loop lengths for the batched per-update slope
# where the sharded solves and loops start (trace, row): on calm rows, as
# phase 4b.  No 512-knot window of trace 0_0 is calm (rows 350.. leave 316
# rows, and from row 0 every f32 step of either route is rejected, so the
# loops would compare equal trivially); trace 3_4 is calm in rows 0-649
SHARD_START = {512: ("3_4", 0), 64: ("0_0", CALM_ROW)}
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
    "K7 pcr_solve_cuda": (
        "mpcgpu_tpu_torch/csrc/pcr.cu",
        "mpcgpu_tpu/ops/pcr_pallas.py:100 pcr_solve_pallas_lanes"),
    "K8a build_kkt_schur_batched": (
        "mpcgpu_tpu_torch/csrc/kkt_schur.cu",
        "mpcgpu_tpu/parallel/batched_fused.py:150 build_kkt_schur_batched"),
    "K8b pcg_solve_batched": (
        "mpcgpu_tpu_torch/csrc/pcg_dz.cu",
        "mpcgpu_tpu/parallel/batched_fused.py:335 pcg_solve_batched_lanes"),
    "K8c compute_dz_batched": (
        "mpcgpu_tpu_torch/csrc/pcg_dz.cu",
        "mpcgpu_tpu/parallel/batched_fused.py:391 compute_dz_batched"),
    "K3b line_search_merits_batched": (
        "mpcgpu_tpu_torch/csrc/merit.cu",
        "mpcgpu_tpu/solver/merit_pallas.py:277 line_search_merits_pallas "
        "(vmapped, batched_fused.py:499)"),
    "K9a build_kkt_schur_slab": (
        "mpcgpu_tpu_torch/csrc/kkt_schur.cu",
        "mpcgpu_tpu/solver/kkt_pallas.py:888 build_kkt_schur_pallas_slab"),
    "K9b compute_dz_slab": (
        "mpcgpu_tpu_torch/csrc/pcg_dz.cu",
        "mpcgpu_tpu/solver/kkt_pallas.py:1020 compute_dz_pallas_slab"),
    "K9c line_search_merit_partials_slab": (
        "mpcgpu_tpu_torch/csrc/merit.cu",
        "mpcgpu_tpu/solver/merit_pallas.py:349 line_search_merit_partials_slab"),
    "K10a pcg_slab_step_cuda": (
        "mpcgpu_tpu_torch/csrc/pcg_slab.cu",
        "mpcgpu_tpu/ops/pcg_pallas.py:252 pcg_slab_step_pallas"),
    "K10b ca_basis_cuda": (
        "mpcgpu_tpu_torch/csrc/pcg_ca.cu",
        "mpcgpu_tpu/ops/pcg_pallas.py:365 pcg_ca_basis_pallas"),
    "K10b' ca_coeff_step_cuda": (
        "mpcgpu_tpu_torch/csrc/pcg_ca.cu",
        "mpcgpu_tpu/parallel/pcg_sharded.py:497-510 (XLA around K10b: "
        "_ca_coeff_iters, the recovery, _ca_next_scale; no pallas_call site)"),
    "K4b simulate_plant_batched": (
        "mpcgpu_tpu_torch/csrc/plant.cu",
        "mpcgpu_tpu/sim/plant_pallas.py:132 simulate_plant_pallas "
        "(vmapped, sim/mpc.py:881-883)"),
}

# The least time the card could take for each kernel's work: the larger of
# its floating-point operations over the f32 peak outside the tensor cores
# and its bytes (each input read once, each output written once) over the
# memory rate (H100 SXM data sheet, at 700 W).  Operation counts are per
# knot or per iteration of the algorithm, counted from its products, for a
# chain of nq links (nx = 2 nq; the constants below are nq = 7's):
#   mv6 (6x6 by 6) 72, a 6x6 product 432, mm4 128 FLOP;
#   rnea_dual: per link 4 mv6 forward, 3 more for I v, I a and their
#     tangents, 3 crf products (~30 each), 2 mv6t backward: ~780 per link;
#   aba: per link 2 mv6 + crf forward, Ia and two 6x6 products backward
#     (nq - 1 links), one mv6 in the last pass: ~1200 per link;
#   fk: nq - 1 mm4 and nq affine 4x4 transforms;
#   K5 per knot: 2 nq + 1 rnea_dual (bias + 2 nq tangents), CRBA (nq - 1
#     pairs of 6x6 products), Gauss-Jordan nq x 2nq, M^-1 dID (nq x nq x
#     nx), FK with nq tangents;
#   K1 per knot: K5 + A Qinv and T (2 nx^3 + nx^2 nq 2), the Schur block's
#     Gauss-Jordan nx x 2nx and the stair bands (4 nx^3 2);
#   K2 per iteration: two BTD matvecs (2 x 3 x nx^2 x 2 per knot), two dots
#     and three axpys over nx per knot; the dz recovery ~1000 per knot at
#     nq = 7 (2 nx^2 + nx nq multiply-adds: Qinv, A^T, B^T), scaled by it.
PEAK_F32 = 67e12
PEAK_F64 = 34e12         # outside the tensor cores (H100 SXM data sheet)
PEAK_BYTES = 3.35e12
MV6, M66, MM4 = 72, 432, 128


def rnea_dual(nq: int = 7) -> int:
    return nq * (7 * MV6 + 3 * 30 + 2 * MV6)


def aba(nq: int = 7) -> int:
    return nq * (2 * MV6 + 30) + (nq - 1) * (72 + 2 * M66 + 2 * MV6) + nq * MV6


def fk(nq: int = 7) -> int:
    return (nq - 1) * MM4 + nq * 48


def kkt_knot(nq: int = 7) -> int:
    nx = 2 * nq
    return ((2 * nq + 1) * rnea_dual(nq) + (nq - 1) * 2 * M66
            + 2 * (nq * nq * nx * 2) + nq * fk(nq))


def schur_knot(nq: int = 7) -> int:
    nx = 2 * nq
    return 2 * nx ** 3 * 2 + nx * nx * nq * 2 + nx * nx * 2 * nx * 2 + 4 * nx ** 3 * 2


def pcg_iter_knot(nq: int = 7) -> int:
    nx = 2 * nq
    return 2 * 3 * nx * nx * 2 + 2 * 2 * nx + 3 * 2 * nx


def dz_knot(nq: int = 7) -> float:
    nx = 2 * nq
    return 1000 * (2 * nx * nx + nx * nq) / 490




# K7 per level and knot (n = nx): one n x n inverse (the least it needs is
#   n^3 multiply-adds, 2 n^3 FLOP), six n x n products (A, B, L', U' and
#   th's two terms) and three mat-vecs (v and b's two terms); the last level
#   one more inverse and a mat-vec; each refinement pass a BTD mat-vec,
#   three mat-vecs per level and the final one, per knot.


def bound(flops: float, floats: float, peak: float = PEAK_F32) -> tuple[float, str]:
    """(least time in ms, "operations" or "bytes") for work of `flops` at
    `peak` (f32 by default) on `floats` 4-byte words."""
    t_ops, t_bytes = flops / peak, 4 * floats / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def kernel_bounds(N: int, k2_iters: int, k2p_iters: int, plant_rows: int,
                  plant_substeps: int, num_cand: int = 9, nq: int = 7) -> dict:
    """Each kernel's (bound_ms, bound_by) at N knots and nq joints, from
    this run's iteration counts and the plan rows the plant window reads."""
    nx, w = 2 * nq, 3 * nq
    nn = nx * nx
    model = 192 * nq             # the packed model; K4 reads its first
    dyn = 4 * nq * 36            # 144 nq floats (X matrices and inertias)
    kkt_out = N * (nn + nx + nx) + (N - 1) * (nn + nx * nq)
    k1_out = N * (2 * 3 * nn + nx + nn + nn + nx * nq + nx)
    pcg_in = N * (2 * 3 * nn + nx + nx)
    dz_in = N * (nn + nn + nx * nq + nx + nq)
    ab, fk_ = aba(nq), fk(nq)
    return {
        "K1 build_kkt_schur": bound(N * (kkt_knot(nq) + schur_knot(nq)),
                                    N * (w + 3) + model + 1 + k1_out),
        "K2 pcg_dz_solve": bound(N * (pcg_iter_knot(nq) * (k2_iters + 1) + dz_knot(nq)),
                                 pcg_in + dz_in + 1 + N * (nx + w) + 2),
        "K3 line_search_merits_fused": bound(num_cand * N * (ab + fk_ + 150),
                                             2 * N * w + nx + 3 * N + model
                                             + 2 * num_cand),
        "K4 simulate_plant": bound(plant_substeps * (ab + nx * 20 + 4 * nq),
                                   nx + nq * plant_rows + dyn + 3 + nx),
        "K5 build_kkt_cuda": bound(N * kkt_knot(nq),
                                   N * (w + 3) + nx + model + kkt_out),
        "K2' pcg_solve_cuda": bound(N * pcg_iter_knot(nq) * (k2p_iters + 1),
                                    pcg_in + N * nx + 2),
        "K6 compute_dz_cuda": bound(N * dz_knot(nq), N * nx + dz_in + 1 + N * w),
    }


def pcr_bound(N: int, refine: int = 1, nq: int = 7) -> tuple[float, str]:
    """K7's (bound_ms, bound_by) at N knots and nx = 2 nq: S and b read, x
    written."""
    n = 2 * nq
    gj, mv = 2 * n ** 3, 2 * n * n
    level_knot = gj + 6 * 2 * n ** 3 + 3 * mv
    levels = (N - 1).bit_length()
    flops = N * (levels * level_knot + gj + mv
                 + refine * (3 * mv + levels * 3 * mv + mv))
    return bound(flops, N * (3 * n * n + n) + N * n)


def batched_bounds(N: int, B: int, k8b_steps: int, num_cand: int = 9,
                   nq: int = 7) -> dict:
    """(bound_ms, bound_by) of K8a-c and the batched K3 for B instances of
    nq joints: B times the single kernels' work; K8b counts the CG steps
    this run's instances took (k8b_steps = the sum over instances of
    iterations + 1)."""
    nx, w = 2 * nq, 3 * nq
    nn, model = nx * nx, 192 * nq
    k1_out = N * (2 * 3 * nn + nx + nn + nn + nx * nq + nx)
    pcg_in = N * (2 * 3 * nn + nx + nx)
    dz_in = N * (nn + nn + nx * nq + nx + nq)
    return {
        "K8a build_kkt_schur_batched": bound(
            B * N * (kkt_knot(nq) + schur_knot(nq)),
            B * (N * (w + 3) + 1 + k1_out) + model),
        "K8b pcg_solve_batched": bound(N * pcg_iter_knot(nq) * k8b_steps,
                                       B * (pcg_in + N * nx + 2)),
        "K8c compute_dz_batched": bound(B * N * dz_knot(nq),
                                        B * (N * nx + dz_in + 1 + N * w)),
        "K3b line_search_merits_batched": bound(
            B * num_cand * N * (aba(nq) + fk(nq) + 150),
            B * (2 * N * w + nx + 3 * N + 2 * num_cand) + model),
    }


def shard_bounds(N: int, n_shard: int, num_cand: int = 9, nq: int = 7) -> dict:
    """(bound_ms, bound_by) of one call of each slab kernel at N knots over
    n_shard shards (L = N / n_shard): K9a is K1 on n_shard windows of L + 4
    knots, K9b K6 on N knots with lam_{k+1} and the last flags as inputs,
    K9c K3's per-knot work on n_shard slabs of L + 1 knots (per-knot terms
    written, not sums), K10a one CG step: the two banded products, three
    dots and four axpys per knot, S and Pinv read once, the six vectors read
    and written once, and the packets; nq joints."""
    nx, w = 2 * nq, 3 * nq
    nn, model = nx * nx, 192 * nq
    L = N // n_shard
    ext, e1 = n_shard * (L + 4), n_shard * (L + 1)
    k1_out = 2 * 3 * nn + nx + nn + nn + nx * nq + nx
    dz_in = N * (nn + nn + nx * nq + nx + nq)
    return {
        "K9a build_kkt_schur_slab": bound(ext * (kkt_knot(nq) + schur_knot(nq)),
                                          ext * (w + 3 + 2 + k1_out) + model + 1),
        "K9b compute_dz_slab": bound(N * dz_knot(nq),
                                     2 * N * nx + N + dz_in + 1 + N * w),
        "K9c line_search_merit_partials_slab": bound(
            num_cand * e1 * (aba(nq) + fk(nq) + 150),
            2 * e1 * w + 3 * e1 + model + 2 * num_cand * e1 + num_cand * n_shard),
        "K10a pcg_slab_step_cuda": bound(
            N * pcg_iter_knot(nq),
            N * 2 * 3 * nn + 12 * N * nx
            + n_shard * (2 * 6 * nx + 2 * 3 * nn + 3 + 2 * 12 * nx + 3 + 2 + 2)),
    }


def ca_bounds(N: int, n_shard: int, s: int = CA_S, nq: int = 7) -> dict:
    """(bound_ms, bound_by) of one call of K10b and of the coefficient step
    at N knots over n_shard shards, their operations in f64: K10b's 4s
    banded products on the extended slab of L + 2h knots (h = 2s+1) and its
    2m^2+2m+1 dot products over the L local knots, S and Pinv on the
    extended slab, p and z extended, r read once, Y and Ytil and the parts
    (f64, two words each) written once; the coefficient step's four m-term
    combinations per row and its s iterations in m dimensions, Y and Ytil
    and the summed parts read, x and r read, x, r, z, p and the packets
    written; nx = 2 nq."""
    nx = 2 * nq
    nn = nx * nx
    L = N // n_shard
    h = m = 2 * s + 1
    Le, P = L + 2 * h, 2 * m * m + 2 * m + 1
    return {
        "K10b ca_basis_cuda": bound(
            n_shard * (4 * s * Le * 3 * nn * 2 + P * L * nx * 2),
            n_shard * (2 * Le * 3 * nn + 2 * Le * nx + L * nx
                       + 2 * (2 * m * L * nx + P) + 2 * 2 + 2), PEAK_F64),
        "K10b' ca_coeff_step_cuda": bound(
            n_shard * (4 * m * L * nx * 2 + s * (4 * m * m * 2 + 12 * m)),
            n_shard * (2 * (2 * m * L * nx + P + 2) + 6 * L * nx + 2 + 1
                       + 4 * h * nx), PEAK_F64),
    }


def plant_batched_bound(B: int, plant_rows: int, plant_substeps: int,
                        nq: int = 7) -> tuple:
    """K4b's (bound_ms, bound_by): B times K4's work (kernel_bounds), the
    model's dynamics floats and the window's three scalars read once."""
    nx = 2 * nq
    return bound(B * plant_substeps * (aba(nq) + nx * 20 + 4 * nq),
                 B * (nx + nq * plant_rows + nx) + 4 * nq * 36 + 3)


def batch_problem(B: int, N: int, torch, device):
    """B instances: trace 0_0 plus numpy noise (sigma 0.01, seed 0), the
    same goal window, rho cycling through 1e-3 x (1, 2, 3, 4); f32 tensors on
    the card."""
    import numpy as np

    from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[:N][None] + 0.01 * rng.standard_normal((B, N, 21))
    ee = np.broadcast_to(load_eepos_traj("0_0")[:N], (B, N, 6))
    rho = 1e-3 * (1 + np.arange(B) % 4)
    f = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)
    return f(xu), f(xu[:, 0, :14]), f(ee), f(rho)


class SmokeFailure(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def problem(N: int, torch, device, seed: int = 0, start: int = 0,
            trace: str = "0_0"):
    """A trace (0_0 by default) from row ``start`` plus numpy noise (sigma
    0.01; seed 0 as bench.py sets up its chain); f32 tensors on the card."""
    import numpy as np

    from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

    xu = load_xu_traj(trace)[start:start + N]
    xu = xu + 0.01 * np.random.default_rng(seed).standard_normal(xu.shape)
    ee_full = load_eepos_traj(trace)[start:]
    f = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)
    return f(xu), f(xu[0, :14]), f(ee_full[:N]), f(ee_full)


def synthetic_btd(N: int, torch, device, seed: int = 1, n: int = 14):
    """A well-conditioned SPD block-tridiagonal system for K2 (f32 S, Pinv,
    gamma of blocks n x n; eigenvalues of S in [0.77, 9.4] at N = 64, n =
    14): diagonal blocks R R^T / n + 3.5 I, off-diagonal blocks 0.3 N(0, 1),
    the stair preconditioner D^-1 - D^-1 T D^-1 of them, gamma N(0, 1).  On
    it f32 rounding stays near 1e-7 over 20 CG steps, so the kernel is held
    to the plain version tightly; on the real Schur system rounding
    dominates."""
    import numpy as np

    rng = np.random.default_rng(seed)
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


def parts(got, ref, nx: int = 14) -> dict:
    """K2 results (lam, dz, ...) compared per part: lam, and dz's state and
    control columns (nx state columns), each as max|got - ref| / max|ref| of
    that part."""
    dz = part_errs(got[1], ref[1], nx)
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


def once_ms(torch, fn) -> float:
    """CUDA-event time of one call of fn, with no warm-up: for plain
    versions whose one call takes seconds."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def slope_us(torch, fn, lo: int, hi: int, runs: int = 3) -> tuple[float, list]:
    """Median over runs of (t(hi) - t(lo)) / (hi - lo) in us, fn(k) timed by
    CUDA events after one warm call fn(lo): the per-unit cost with the
    per-call set-up cancelled."""
    fn(lo)
    torch.cuda.synchronize()
    slopes = []
    for _ in range(runs):
        t = {k: once_ms(torch, lambda: fn(k)) * 1e3 for k in (lo, hi)}
        slopes.append((t[hi] - t[lo]) / (hi - lo))
    return statistics.median(slopes), slopes


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


def ptxas_summary(log: str) -> list:
    """One line per kernel of an nvcc -Xptxas -v log: its name (and template
    argument), registers, stack frame and spill stores and loads."""
    out, name, props = [], "?", ""
    for line in log.splitlines():
        sym = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if sym:
            # the length-prefixed identifier that ends in "kernel", and its
            # template argument (ILi32E, ILb1E)
            text = sym.group(1)
            # (a digit run may carry a hash's last digits before the length)
            for m in re.finditer(r"(?<!\d)(\d+)(?=[A-Za-z_])", text):
                run = m.group(1)
                lengths = [int(run[j:]) for j in range(len(run))]
                hits = [text[m.end():m.end() + n] for n in lengths
                        if text[m.end():m.end() + n].endswith("kernel")]
                if hits:
                    ident = hits[0]
                    arg = re.match(r"IL[ib](\d+)E", text[m.end() + len(ident):])
                    name = ident + (f"<{arg.group(1)}>" if arg else "")
                    break
        elif "spill" in line:
            props = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers, {props}")
            name, props = "?", ""
    return out


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|)."""
    d = float((got.double() - ref.double()).abs().max())
    s = float(ref.double().abs().max())
    return d, d / max(s, 1e-30)


# ---- the onboarding slice: K1-K4 at the chains' joint counts -------------
NQ_CASES = (3, 5)          # chains beside the IIWA's 7 (the JAX tests' 3-link
                           # arm, the chain tracker's default 5)
NQ_SIZES = (16, 64, 512)   # K1-K4 against their plain versions
NQ_KERNELS = ("K1 build_kkt_schur", "K2 pcg_dz_solve",
              "K3 line_search_merits_fused", "K4 simulate_plant",
              "K4b simulate_plant_batched")
NQ_BATCH = 64              # K4b's instances at nq = 3, 5
TRACK_NQ, TRACK_KNOTS, TRACK_STEPS = 5, 64, 240   # the chain tracker's loop
TRACK_COMPARE = 64         # its first updates, held to the f64 ensemble
TRACK_ENSEMBLE = 4         # plain f64 loops from 1-ulp trace changes
TRACK_SLOPE = (48, 144)    # loop lengths for the per-update slope
SMALL_NQ_UPDATES = 48      # the nq = 3 loop (N = 16), for K4's launches


def chain_model(nq: int, torch, device, dtype=None):
    """The chain tracker's planar arm of nq links (track_chain.build_model)."""
    from mpcgpu_tpu_torch.track_chain import build_model

    return build_model(nq, device=device, dtype=dtype or torch.float32)[0]


def chain_problem(nq: int, N: int, torch, device, seed: int = 0):
    """The chain tracker's reference trace of N rows for the planar arm of
    nq links (made at f64) plus numpy noise (sigma 0.01, as problem() adds
    to the IIWA's trace); f32 xu, xs, ee on the card."""
    import numpy as np

    from mpcgpu_tpu_torch.track_chain import reference_trace

    xu, ee = reference_trace(chain_model(nq, torch, "cpu", torch.float64), N)
    xu = xu + 0.01 * np.random.default_rng(seed).standard_normal(xu.shape)
    f = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)
    return f(xu), f(xu[0, :2 * nq]), f(ee)


def nq_kernel_checks(c) -> dict:
    """Phase 2a: K1, K2, K3, K4 and K4b at nq = 3 and 5 against their plain
    versions on the card, at N = 16, 64 and 512, with the tolerances of
    their nq = 7 checks (phase 2): K1 5e-5 max|ref| per output (both
    integrators), K2 on synthetic_btd at nx = 6, 10 within 2e-6 per part
    and on the real system by medians over REAL_SEEDS seeds (the kernel's
    distance to the f64 solve at most 2x the plain version's), K3 1e-4
    relative per merit with equal alphas, K4 1e-6 max|x| over the plant
    windows and one 2 ms window equal to two 1 ms windows bit for bit, K4b
    equal to K4 per instance bit for bit.  Returns {nq: {kernel: max|d| at
    N_MAIN}}."""
    import numpy as np

    from mpcgpu_tpu_torch.config import CostConfig
    from mpcgpu_tpu_torch.ops.pcg_cuda import pcg_dz_solve, pcg_dz_solve_plain
    from mpcgpu_tpu_torch.sim.plant_cuda import (simulate_plant,
                                                 simulate_plant_batched,
                                                 simulate_plant_batched_plain,
                                                 simulate_plant_plain)
    from mpcgpu_tpu_torch.solver.kkt_cuda import (build_kkt_schur,
                                                  build_kkt_schur_plain)
    from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merits_fused,
                                                    line_search_merits_plain)

    torch, dev, expect = c.torch, c.dev, c.expect
    mu = 10.0
    errs = {nq: {k: 0.0 for k in NQ_KERNELS} for nq in NQ_CASES}
    for nq in NQ_CASES:
        nx = 2 * nq
        model = chain_model(nq, torch, dev)
        for N in NQ_SIZES:
            cost = CostConfig.for_knots(N)
            xu, xs, ee = chain_problem(nq, N, torch, dev)
            rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
            tag = f"nq={nq} N={N}"
            for integ in (0, 1):
                got = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, integ)
                ref = build_kkt_schur_plain(model, cost, xu, xs, ee, rho, DT, integ)
                torch.cuda.synchronize()
                worst = max(rel_err(got[k], ref[k])[1] for k in got)
                if N == N_MAIN:
                    errs[nq]["K1 build_kkt_schur"] = max(
                        errs[nq]["K1 build_kkt_schur"],
                        *(rel_err(got[k], ref[k])[0] for k in got))
                expect(worst <= 5e-5, f"K1 {tag} integrator={integ}: worst "
                       f"output {worst:.3e} max|ref| (<= 5e-5)")
            sys_ = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0)
            lam0 = torch.zeros((N, nx), dtype=torch.float32, device=dev)
            u = xu[:, nx:]
            # K2 on the well-conditioned system, with K1's blocks for the
            # epilogue: fixed steps below f32 CG's underflow on it (NaN from
            # step 20 at nx = 6, N = 16; 24 at nx = 10), then both exits
            syn = dict(sys_)
            syn["S"], syn["Pinv"], syn["gamma"] = synthetic_btd(N, torch, dev, n=nx)
            fixed = min(20, 2 * N, 2 * nx)
            for crit, tol, cap in (("eta", 0.0, fixed), ("eta", 1e-9, 167),
                                   ("rnorm", 1e-5, 167)):
                kw = dict(max_iter=cap, exit_tol=tol, exit_criterion=crit)
                got = pcg_dz_solve(syn, lam0, u, rho, cost.r_cost, **kw)
                ref = pcg_dz_solve_plain(syn, lam0, u, rho, cost.r_cost, **kw)
                torch.cuda.synchronize()
                e = parts(got, ref, nx)
                ik, ip = int(got[2]), int(ref[2])
                case = f"K2 {tag} well-conditioned {crit} exit_tol={tol:g} cap={cap}"
                expect(max(e.values()) <= 2e-6, f"{case}: {fmt(e)} (<= 2e-6)")
                if tol == 0.0:
                    expect(ik == ip == cap, f"{case}: steps kernel {ik}, plain {ip} (= {cap})")
                else:
                    expect(abs(ik - ip) <= 2 and ik < cap and bool(got[3]) and bool(ref[3]),
                           f"{case}: iters kernel {ik}, plain {ip} (differ by <= 2, "
                           f"< cap); converged kernel {bool(got[3])}, plain {bool(ref[3])}")
            # K2 on the real system, fixed steps, by medians over the seeds
            dist = {steps: {w: {key: [] for key in ("lam", "dz x", "dz u")}
                            for w in ("kernel", "plain")} for steps in (1, 20)}
            for seed in range(REAL_SEEDS):
                xu_s, xs_s, ee_s = chain_problem(nq, N, torch, dev, seed)
                sys_s = build_kkt_schur(model, cost, xu_s, xs_s, ee_s, rho, DT, 0)
                sys64 = {k: v.double() for k, v in sys_s.items()}
                u_s = xu_s[:, nx:]
                for steps in (1, 20):
                    kw = dict(max_iter=steps, exit_tol=0.0)
                    got = pcg_dz_solve(sys_s, lam0, u_s, rho, cost.r_cost, **kw)
                    ref = pcg_dz_solve_plain(sys_s, lam0, u_s, rho, cost.r_cost, **kw)
                    f64 = pcg_dz_solve_plain(sys64, lam0.double(), u_s.double(),
                                             rho.double(), cost.r_cost, **kw)
                    if N == N_MAIN:
                        errs[nq]["K2 pcg_dz_solve"] = max(
                            errs[nq]["K2 pcg_dz_solve"], rel_err(got[0], ref[0])[0],
                            rel_err(got[1], ref[1])[0])
                    for w, res_ in (("kernel", got), ("plain", ref)):
                        for key, v in parts(res_, f64, nx).items():
                            dist[steps][w][key].append(v)
                    expect(int(got[2]) == int(ref[2]) == steps,
                           f"K2 {tag} real system seed {seed}: steps kernel "
                           f"{int(got[2])}, plain {int(ref[2])} (= {steps})")
            for steps, d in dist.items():
                for key in d["kernel"]:
                    med = {w: statistics.median(v[key]) for w, v in d.items()}
                    expect(med["kernel"] <= 2 * med["plain"],
                           f"K2 {tag} real system, {steps} fixed steps, {key}: "
                           f"median distance to f64 over {REAL_SEEDS} seeds kernel "
                           f"{med['kernel']:.3e}, plain {med['plain']:.3e} "
                           f"(kernel <= 2x plain)")
            # K3 on K2's step and on a random one
            dz = pcg_dz_solve(sys_, lam0, u, rho, cost.r_cost, max_iter=167,
                              exit_tol=1e-5)[1]
            rnd = torch.tensor(0.05 * np.random.default_rng(3).standard_normal(
                (N, 3 * nq)), dtype=torch.float32, device=dev)
            for name, step in (("K2's dz", dz), ("a random dz", rnd)):
                m_got, a_got = line_search_merits_fused(model, cost, xu, step, xs,
                                                        ee, mu, DT)
                m_ref, a_ref = line_search_merits_plain(model, cost, xu, step, xs,
                                                        ee, mu, DT)
                torch.cuda.synchronize()
                rel = float(((m_got.double() - m_ref.double()).abs()
                             / m_ref.double().abs()).max())
                if N == N_MAIN:
                    errs[nq]["K3 line_search_merits_fused"] = max(
                        errs[nq]["K3 line_search_merits_fused"],
                        float((m_got.double() - m_ref.double()).abs().max()))
                expect(rel <= 1e-4 and torch.equal(a_got, a_ref),
                       f"K3 {tag} on {name}: merits max relative error {rel:.3e} "
                       f"(<= 1e-4), alphas equal {torch.equal(a_got, a_ref)}")
            # K4 over the plant windows from a perturbed state
            xs4 = xs + 0.01 * torch.tensor(np.random.default_rng(1).standard_normal(nx),
                                           dtype=torch.float32, device=dev)
            for t_off, sim_t in PLANT_WINDOWS:
                a4 = simulate_plant(model, xs4, xu, t_off, sim_t, DT, 10, 2e-4)
                b4 = simulate_plant_plain(model, xs4, xu, t_off, sim_t, DT, 10, 2e-4)
                torch.cuda.synchronize()
                d, r = rel_err(a4, b4)
                moved = float((b4 - xs4).abs().max())
                if N == N_MAIN:
                    errs[nq]["K4 simulate_plant"] = max(errs[nq]["K4 simulate_plant"], d)
                expect(r <= 1e-6 and moved > 0.0,
                       f"K4 {tag} window t_off={t_off:g} s, {sim_t:g} s: max|d|="
                       f"{d:.3e} = {r:.3e} max|x| (<= 1e-6); moved {moved:.3e}")
            # one 2 ms window against two 1 ms windows: in f32 the clip
            # schedules differ by their last steps (ten of 0.2 ms and one of
            # 2.3e-10 s against 2 x (five and one of 1.2e-10 s)), which move
            # a slow state's last bits, so they agree to K4's tolerance
            a1 = simulate_plant(model, xs4, xu, 0.0, 1e-3, DT, 10, 2e-4)
            a2 = simulate_plant(model, a1, xu, 1e-3, 1e-3, DT, 10, 2e-4)
            a4 = simulate_plant(model, xs4, xu, 0.0, 2e-3, DT, 10, 2e-4)
            torch.cuda.synchronize()
            d, r = rel_err(a2, a4)
            expect(r <= 1e-6, f"K4 {tag}: one 2 ms window vs two 1 ms windows "
                   f"max|d|={d:.3e} = {r:.3e} max|x| (<= 1e-6); bitwise equal "
                   f"{torch.equal(a4, a2)}")
        # K4b over NQ_BATCH instances of N_MAIN knots
        xu, xs, ee = chain_problem(nq, N_MAIN, torch, dev)
        rng = np.random.default_rng(4)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        xs_b = xs + t(0.01 * rng.standard_normal((NQ_BATCH, nx)))
        plans = xu + t(0.01 * rng.standard_normal((NQ_BATCH, N_MAIN, 3 * nq)))
        args = (2e-3, 2e-3, DT, 10, 2e-4)
        kb = simulate_plant_batched(model, xs_b, plans, *args)
        ks = torch.stack([simulate_plant(model, xs_b[i], plans[i], *args)
                          for i in range(NQ_BATCH)])
        pb = simulate_plant_batched_plain(model, xs_b, plans, *args)
        torch.cuda.synchronize()
        d, r = rel_err(kb, pb)
        errs[nq]["K4b simulate_plant_batched"] = d
        expect(torch.equal(kb, ks) and r <= 1e-6,
               f"K4b nq={nq} B={NQ_BATCH}: == K4 per instance bit for bit "
               f"{torch.equal(kb, ks)}; vs plain max|d|={d:.3e} = {r:.3e} max|x| "
               f"(<= 1e-6)")
    return errs


def onboarding_checks(c) -> dict:
    """Phase 4f: the onboarding path on the card.  The fused SQP on the JAX
    tests' 3-link problem against the plain f32 and f64 solves; the chain
    tracker's loop at nq = 5, N = 64 over its 240-row trace on the device
    and the host loop through K1-K4, held to the spread of plain f64 loops
    from 1-ulp changes of the trace; a loop at nq = 3; and the IIWA-14
    loaded from its own URDF through K1-K4.  Returns the launches of the
    loops at each nq and a summary."""
    import numpy as np

    from mpcgpu_tpu_torch import track_chain
    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SimConfig, SQPConfig
    from mpcgpu_tpu_torch.models import dynamics, iiwa14, load_urdf, planar_arm
    from mpcgpu_tpu_torch.models.urdf import export_urdf
    from mpcgpu_tpu_torch.ops.pcg_cuda import pcg_dz_solve
    from mpcgpu_tpu_torch.sim.mpc import simulate_mpc
    from mpcgpu_tpu_torch.sim.plant_cuda import simulate_plant
    from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur
    from mpcgpu_tpu_torch.solver.merit_cuda import line_search_merits_fused
    from mpcgpu_tpu_torch.solver.sqp import sqp_solve

    torch, dev, expect, counted = c.torch, c.dev, c.expect, c.counted
    k1_k3 = ("K1 build_kkt_schur", "K2 pcg_dz_solve", "K3 line_search_merits_fused")
    out = {"launches": {}}

    def finite(*ts):
        return all(bool(torch.isfinite(torch.as_tensor(t)).all()) for t in ts)

    # the fused SQP on tests/test_chain_models.py's 3-link problem: within
    # that test's tolerance (rtol 2e-3, atol 1e-3; 12 f32 iterations deep)
    # of the plain f32 solve and of the f64 solve, and moving the arm
    # toward the goal
    N3 = 16
    cfg = (CostConfig(qd_cost=1e-3, r_cost=1e-4), SQPConfig(max_iter=12),
           PCGConfig(max_iter=60, exit_tol=1e-8))
    solves = {}
    for name, dtype, kw in (("kernels", torch.float32, dict(linsys="pcg_cuda")),
                            ("plain f32", torch.float32,
                             dict(linsys="pcg", merit_impl="plain")),
                            ("plain f64", torch.float64,
                             dict(linsys="pcg", merit_impl="plain"))):
        m3 = planar_arm(3, dtype=dtype, device=dev)
        xu = torch.zeros((N3, 9), dtype=dtype, device=dev)
        xu[:, :3] = torch.tensor([0.1, 0.2, -0.1], dtype=dtype, device=dev)
        goal = dynamics.fk_ee(m3, torch.tensor([0.5, 0.3, 0.2], dtype=dtype, device=dev))
        ee = goal.expand(N3, 6).contiguous()
        solves[name] = counted(sqp_solve, m3, *cfg, xu,
                               torch.zeros((N3, 6), dtype=dtype, device=dev),
                               xu[0, :6].contiguous(), ee, 1e-3, 1 / 32.0, **kw)
    (kern, n3), ref, f64 = solves["kernels"], solves["plain f32"][0], solves["plain f64"][0]
    it = int(kern.sqp_iters)
    err = lambda r: float(np.linalg.norm(goal[:3].cpu().double().numpy() - dynamics.fk_ee_xyz(
        planar_arm(3, dtype=torch.float64, device="cpu"),
        r.xu[-1, :3].cpu().double()).numpy()))
    err0 = float(np.linalg.norm(goal[:3].cpu().double().numpy() - dynamics.fk_ee_xyz(
        planar_arm(3, dtype=torch.float64, device="cpu"),
        torch.tensor([0.1, 0.2, -0.1], dtype=torch.float64)).numpy()))
    close = lambda a, b: bool(torch.allclose(a.xu.double(), b.xu.double(), rtol=2e-3,
                                             atol=1e-3))
    print(f"  3-link SQP: PCG iterations kernels {kern.pcg_iters.tolist()}, plain "
          f"{ref.pcg_iters.tolist()}, f64 {f64.pcg_iters.tolist()}; line search "
          f"{kern.ls_alpha_idx.tolist()} / {ref.ls_alpha_idx.tolist()} / "
          f"{f64.ls_alpha_idx.tolist()}")
    expect(all(n3[k] == it for k in k1_k3) and finite(kern.xu, kern.lam)
           and close(kern, ref) and close(kern, f64) and err(kern) < 0.85 * err0,
           f"fused SQP, 3-link arm, N={N3}: K1-K3 launched {[n3[k] for k in k1_k3]} "
           f"times ({it} SQP iterations); xu vs plain f32 max|d| "
           f"{rel_err(kern.xu, ref.xu)[0]:.3e}, vs f64 {rel_err(kern.xu, f64.xu)[0]:.3e} "
           f"(rtol 2e-3, atol 1e-3); ee error {err0:.4f} -> {err(kern):.4f} "
           f"(< 0.85x; plain {err(ref):.4f}, f64 {err(f64):.4f})")
    out["launches"][3] = dict(n3)

    # the chain tracker at nq = 5, N = 64 over its 240-row trace: the device
    # loop (the whole trace) and the host loop at the device loop's
    # configuration (its first TRACK_COMPARE updates), both through K1-K4
    model = chain_model(TRACK_NQ, torch, dev)
    xu_t, ee_t = track_chain.reference_trace(model, TRACK_STEPS)
    run, n_dev = counted(track_chain.track, model, xu_t, ee_t, TRACK_KNOTS,
                         ondevice=True)
    ups, its = run["control_updates"], int(run["sqp_iters"].sum())
    err_dev = run["tracking_errors"].double().cpu().numpy()
    expect(n_dev["K4 simulate_plant"] == ups and all(n_dev[k] == its for k in k1_k3)
           and finite(run["tracking_errors"], run["xs_path"]),
           f"chain tracker nq={TRACK_NQ} N={TRACK_KNOTS} on the device: {ups} "
           f"updates, {len(err_dev)} shifts, launches K1-K3 "
           f"{[n_dev[k] for k in k1_k3]} ({its} SQP iterations), K4 "
           f"{n_dev['K4 simulate_plant']}; mean tracking error {err_dev.mean():.6g}, "
           f"final {float(run['final_tracking_error']):.6g}")
    out["launches"][TRACK_NQ] = dict(n_dev)
    update_us, runs = slope_us(torch, lambda n: track_chain.track(
        model, xu_t, ee_t, TRACK_KNOTS, ondevice=True, max_updates=n), *TRACK_SLOPE)
    print(f"  chain tracker nq={TRACK_NQ} N={TRACK_KNOTS} on the device: "
          f"{update_us:.1f} us per control update (slope {TRACK_SLOPE}, runs "
          f"{', '.join(f'{v:.1f}' for v in runs)}; "
          f"{track_chain.DEVICE_SQP.max_iter} SQP iterations each)")
    out["track_update_us"] = update_us
    host, n_host = counted(
        simulate_mpc, model, xu_t, ee_t, TRACK_KNOTS, DT, cost=track_chain.COST,
        sqp_cfg=track_chain.DEVICE_SQP, pcg_cfg=track_chain.PCG,
        sim_cfg=SimConfig(max_control_updates=TRACK_COMPARE))
    err_host = np.asarray(host.tracking_errors)
    k = len(err_host)
    same = bool(np.array_equal(err_host, err_dev[:k]))
    # (the host loop's warm-up solve launches K1-K3 too)
    expect(k >= 4 and n_host["K4 simulate_plant"] == TRACK_COMPARE
           and all(n_host[kk] >= sum(host.sqp_iters) for kk in k1_k3)
           and bool(np.all(np.abs(err_host - err_dev[:k]) <= 5e-3 + 0.1 * np.abs(err_dev[:k]))),
           f"host loop ({TRACK_COMPARE} updates, {k} shifts) vs the device "
           f"loop's first: max|d| {float(np.abs(err_host - err_dev[:k]).max()):.3e} "
           f"(rtol 0.1, atol 5e-3); bitwise equal {same}; launches {n_host}")
    # track_chain's own host loop (4 SQP iterations a solve, 600 updates)
    drv, n_drv = counted(track_chain.track, model, xu_t, ee_t, TRACK_KNOTS)
    s = drv.summary()
    expect(s["control_updates"] == track_chain.HOST_UPDATES
           and n_drv["K4 simulate_plant"] == s["control_updates"]
           and all(n_drv[kk] >= sum(drv.sqp_iters) for kk in k1_k3)
           and np.isfinite(s["avg_tracking_error"]),
           f"track_chain's host loop: {s['control_updates']} updates, "
           f"{sum(drv.sqp_iters)} SQP iterations, launches K1-K4 "
           f"{[n_drv[kk] for kk in k1_k3 + ('K4 simulate_plant',)]}; avg tracking "
           f"error {s['avg_tracking_error']:.6g}, avg PCG iterations "
           f"{s['avg_pcg_iters']:.1f}, avg solve {s['avg_sqp_time_us']:.1f} us")
    # the yardstick: plain f64 loops (on the CPU, where the plant's plain
    # version runs) from the trace and from TRACK_ENSEMBLE copies moved by
    # one f32 ulp per entry, their first TRACK_COMPARE updates; the kernel
    # loop's mean tracking error over the same shifts lies in their range
    # widened on each side by its own ratio hi/lo (phase 4's band)
    m64 = chain_model(TRACK_NQ, torch, "cpu", torch.float64)
    rng = np.random.default_rng(5)
    xu32 = xu_t.astype(np.float32)
    ens = []
    for i in range(TRACK_ENSEMBLE + 1):
        trace = xu32 if i == 0 else np.nextafter(
            xu32, np.where(rng.random(xu32.shape) < 0.5, -np.inf, np.inf)
            .astype(np.float32))
        r64 = track_chain.track(m64, trace.astype(np.float64), ee_t, TRACK_KNOTS,
                                ondevice=True, max_updates=TRACK_COMPARE,
                                linsys="pcg", merit_impl="plain")
        ens.append(float(r64["tracking_errors"].mean()))
    lo, hi = min(ens), max(ens)
    band = spread_band(ens)
    mine = float(err_dev[:k].mean())
    print(f"  plain f64 loops ({TRACK_ENSEMBLE} from 1-ulp trace changes + the "
          f"trace): mean tracking error over {k} shifts {lo:.9g}..{hi:.9g} (band "
          f"{band[0]:.9g}..{band[1]:.9g})")
    expect(band[0] <= mine <= band[1],
           f"chain tracker, kernels (device and host loop): mean tracking error "
           f"over the first {k} shifts {mine:.9g} (in {band[0]:.9g}..{band[1]:.9g})")
    out.update(track_mean_err=float(err_dev.mean()), track_updates=ups,
               track_band=band, track_compare_err=mine,
               host_avg_solve_us=s["avg_sqp_time_us"])

    # a loop at nq = 3 (N = 16): K4's launches at that nq
    m3 = chain_model(3, torch, dev)
    xu3, ee3 = track_chain.reference_trace(m3, 40)
    run3, n_3 = counted(track_chain.track, m3, xu3, ee3, 16, ondevice=True,
                        max_updates=SMALL_NQ_UPDATES)
    its3 = int(run3["sqp_iters"].sum())
    expect(n_3["K4 simulate_plant"] == SMALL_NQ_UPDATES
           and all(n_3[kk] == its3 for kk in k1_k3)
           and finite(run3["tracking_errors"], run3["xs_path"]),
           f"chain tracker nq=3 N=16 on the device: {SMALL_NQ_UPDATES} updates, "
           f"launches K1-K3 {[n_3[kk] for kk in k1_k3]} ({its3} SQP "
           f"iterations), K4 {n_3['K4 simulate_plant']}; mean tracking error "
           f"{float(run3['tracking_errors'].double().mean()):.6g}")
    for kk in k1_k3:
        n_3[kk] += n3[kk]
    out["launches"][3] = dict(n_3)

    # the IIWA-14 from its own URDF through K1-K4 at N_MAIN: where the f32
    # packed models are equal, the outputs must be too; else within the f32
    # band of the kernels' checks against their plain versions.  On the
    # calm rows (CALM_ROW): from row 0 the Schur system has cond ~1e13, and
    # an entry of 1.2e-16 in place of an exact zero (sin(pi) in the URDF's
    # rpy) moves D = theta^-1 by ~1e-3 of its size
    mi = iiwa14(torch.float32, device=dev)
    mu_ = load_urdf(export_urdf(iiwa14(torch.float32, device="cpu")), device=dev)
    same_model = torch.equal(mi.packed(), mu_.packed())
    xu, xs, ee, _ = problem(N_MAIN, torch, dev, start=CALM_ROW)
    cost = CostConfig.for_knots(N_MAIN)
    rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
    res = {}
    for name, m in (("iiwa14", mi), ("urdf", mu_)):
        k1 = build_kkt_schur(m, cost, xu, xs, ee, rho, DT, 0)
        k2 = pcg_dz_solve(k1, torch.zeros((N_MAIN, 14), device=dev), xu[:, 14:],
                          rho, cost.r_cost, max_iter=1, exit_tol=0.0)
        k3 = line_search_merits_fused(m, cost, xu, k2[1], xs, ee, 10.0, DT)[0]
        k4 = simulate_plant(m, xs, xu, 2e-3, 2e-3, DT, 10, 2e-4)
        res[name] = (k1, k2, k3, k4)
    torch.cuda.synchronize()
    (a1, a2, a3, a4), (b1, b2, b3, b4) = res["iiwa14"], res["urdf"]
    if same_model:
        ok = (all(torch.equal(a1[kk], b1[kk]) for kk in a1)
              and torch.equal(a2[0], b2[0]) and torch.equal(a2[1], b2[1])
              and torch.equal(a3, b3) and torch.equal(a4, b4))
        rule = "the packed f32 models are equal bit for bit: every output equal bit for bit"
    else:
        r3 = float(((a3.double() - b3.double()).abs() / a3.double().abs()).max())
        e1 = max(rel_err(b1[kk], a1[kk])[1] for kk in a1)
        e2 = max(parts(b2, a2).values())
        e4 = rel_err(b4, a4)[1]
        ok = e1 <= 5e-5 and e2 <= 1e-3 and r3 <= 1e-4 and e4 <= 1e-6
        rule = (f"the packed f32 models differ ({int((mu_.packed() != mi.packed()).sum())} "
                f"entries, max|d| {rel_err(mu_.packed(), mi.packed())[0]:.3e}): K1 "
                f"{e1:.3e} (<= 5e-5), K2 one step {e2:.3e} (<= 1e-3), K3 {r3:.3e} "
                f"(<= 1e-4), K4 {e4:.3e} (<= 1e-6) relative")
    expect(ok, f"builtin:iiwa (load_urdf(export_urdf(iiwa14()))) through K1-K4 at "
           f"N={N_MAIN}: {rule}")
    out["builtin_iiwa_bitwise_model"] = same_model
    return out


def nq_timings(c, launches: dict, errs: dict) -> dict:
    """Phase 5's times of K1-K4 and K4b at nq = 3 and 5 on N_MAIN knots of
    the chain tracker's trace, each beside its plain version and its bound
    at that nq (plain, kernel, kernel, plain, as the nq = 7 rows)."""
    import numpy as np

    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig
    from mpcgpu_tpu_torch.ops.pcg_cuda import pcg_dz_solve, pcg_dz_solve_plain
    from mpcgpu_tpu_torch.sim.plant_cuda import (simulate_plant,
                                                 simulate_plant_batched,
                                                 simulate_plant_batched_plain,
                                                 simulate_plant_plain)
    from mpcgpu_tpu_torch.solver.kkt_cuda import (build_kkt_schur,
                                                  build_kkt_schur_plain)
    from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merits_fused,
                                                    line_search_merits_plain)

    torch, dev = c.torch, c.dev
    N = N_MAIN
    cost = CostConfig.for_knots(N)
    rows = {}
    for nq in NQ_CASES:
        nx = 2 * nq
        model = chain_model(nq, torch, dev)
        xu, xs, ee = chain_problem(nq, N, torch, dev)
        rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
        sys_ = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0)
        lam0 = torch.zeros((N, nx), dtype=torch.float32, device=dev)
        pcg_kw = dict(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)
        u = xu[:, nx:]
        _, dz, k2_iters, _ = pcg_dz_solve(sys_, lam0, u, rho, cost.r_cost, **pcg_kw)
        xs4 = xs + 0.01 * torch.tensor(np.random.default_rng(1).standard_normal(nx),
                                       dtype=torch.float32, device=dev)
        rng = np.random.default_rng(4)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        xs_b = xs + t(0.01 * rng.standard_normal((NQ_BATCH, nx)))
        plans = xu + t(0.01 * rng.standard_normal((NQ_BATCH, N, 3 * nq)))
        t_off, period, n_sub = 2e-3, 2e-3, 10
        plant_rows = len({min(int((t_off + i * 2e-4) / DT), N - 1)
                          for i in range(n_sub + 1)})
        bounds = kernel_bounds(N, int(k2_iters), 0, plant_rows, n_sub + 1, nq=nq)
        bounds["K4b simulate_plant_batched"] = plant_batched_bound(
            NQ_BATCH, plant_rows, n_sub + 1, nq)
        args = (t_off, period, DT, n_sub, 2e-4)
        pairs = {
            "K1 build_kkt_schur": (
                lambda: build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0),
                lambda: build_kkt_schur_plain(model, cost, xu, xs, ee, rho, DT, 0)),
            "K2 pcg_dz_solve": (
                lambda: pcg_dz_solve(sys_, lam0, u, rho, cost.r_cost, **pcg_kw),
                lambda: pcg_dz_solve_plain(sys_, lam0, u, rho, cost.r_cost, **pcg_kw)),
            "K3 line_search_merits_fused": (
                lambda: line_search_merits_fused(model, cost, xu, dz, xs, ee, 10.0, DT),
                lambda: line_search_merits_plain(model, cost, xu, dz, xs, ee, 10.0, DT)),
            "K4 simulate_plant": (
                lambda: simulate_plant(model, xs4, xu, *args),
                lambda: simulate_plant_plain(model, xs4, xu, *args)),
            "K4b simulate_plant_batched": (
                lambda: simulate_plant_batched(model, xs_b, plans, *args),
                lambda: simulate_plant_batched_plain(model, xs_b, plans, *args)),
        }
        print(f"  nq={nq}: K2 at the timed state {int(k2_iters)} PCG iterations")
        rows[nq] = {}
        for name, (kern, plain_fn) in pairs.items():
            reps = 1 if name == "K4b simulate_plant_batched" else 5
            p1 = time_ms(torch, plain_fn, reps)
            k1 = graph_ms(torch, kern)
            k2 = graph_ms(torch, kern)
            p2 = time_ms(torch, plain_fn, reps)
            ms, plain_ms = statistics.median([k1, k2]), statistics.median([p1, p2])
            bound_ms, bound_by = bounds[name]
            rows[nq][name] = dict(launches=launches[nq].get(name, 0),
                                  max_abs_err=errs[nq][name], ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=None)
            if name == "K2 pcg_dz_solve":
                rows[nq][name]["us_per_iter"] = ms * 1e3 / max(int(k2_iters), 1)
            print(f"  {name} nq={nq}: kernel {ms * 1e3:.1f} us (device), plain "
                  f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us "
                  f"({bound_by})")
    return rows


def knot_windows(c, N: int, S: int, lo: int, hi: int):
    """(S, L - lo + hi) knot indices of each shard's window: its L knots
    from row lo to row L - 1 + hi, wrapped around the ring."""
    import numpy as np

    L = N // S
    return c.torch.tensor((np.arange(S)[:, None] * L + np.arange(lo, L + hi)) % N,
                          device=c.dev)


def k10a_synthetic_checks(c, mesh, N: int, S: int, syn) -> float:
    """K10a in the sharded PCG loop against the same loop with its plain
    step, and against K2', on the well-conditioned system ``syn`` (f32
    rounding ~1e-7 there): lam within 2e-6, the same iterations, by a fixed
    step count and both exits.  Returns K10a's max|d| against the plain step
    at the fixed steps."""
    from mpcgpu_tpu_torch.ops.pcg_cuda import pcg_solve_cuda
    from mpcgpu_tpu_torch.ops.pcg_slab import pcg_slab_step
    from mpcgpu_tpu_torch.ops.pcg_slab_cuda import (pcg_slab_step_cuda,
                                                    slab_cluster_plan)

    torch, nx = c.torch, syn[2].shape[-1]
    dp = 0.0
    for crit, tol, cap in (("eta", 0.0, min(20, 2 * nx)), ("eta", 1e-9, 167),
                           ("rnorm", 1e-5, 167)):
        a = slab_pcg_run(c, mesh, *syn, pcg_slab_step_cuda, cap, tol, crit)
        b = slab_pcg_run(c, mesh, *syn, pcg_slab_step, cap, tol, crit)
        k2p = pcg_solve_cuda(*syn, torch.zeros_like(syn[2]), max_iter=cap,
                             exit_tol=tol, exit_criterion=crit)
        torch.cuda.synchronize()
        (d, ep), e2 = rel_err(a[0], b[0]), rel_err(a[0], k2p.lam)[1]
        if tol == 0.0:
            dp = d
        ok = ep <= 2e-6 and e2 <= 2e-6 and a[1] == b[1] == int(k2p.iters)
        ok = ok and a[2] == b[2] == bool(k2p.converged) == (tol > 0.0)
        c.expect(ok, f"K10a N={N} over {S} shards nx={nx} "
                 f"({slab_cluster_plan(N // S, nx=nx)}), well-conditioned {crit} "
                 f"exit_tol={tol:g} cap={cap}: sharded PCG vs its plain step "
                 f"{ep:.3e}, vs K2' {e2:.3e} (<= 2e-6); iterations K10a {a[1]}, "
                 f"plain {b[1]}, K2' {int(k2p.iters)} (equal); converged {a[2]}")
    return dp


def ca_step_checks(c, mesh, N: int, S: int, label: str, sys3) -> tuple:
    """K10b and the coefficient step against their plain versions at the
    second outer step of a solve (g != 1): both do the s-step algebra in
    f64 from the f32 state, in their own orders, so each output is held to
    the same step from the state in f64: the kernel's max|d| / max|ref|
    within 2x the plain step's + 1e-6.  Returns the kernels' max|d| against
    the plain versions (K10b, K10b')."""
    from mpcgpu_tpu_torch import _kernels
    from mpcgpu_tpu_torch.ops.pcg_ca import ca_basis, ca_coeff_step
    from mpcgpu_tpu_torch.ops.pcg_ca_cuda import (ca_basis_cuda, ca_cluster_plan,
                                                  ca_coeff_step_cuda)

    torch, nx = c.torch, sys3[2].shape[-1]
    tol0 = _kernels.scalar(0.0, c.dev)
    st, ins = ca_setup_run(c, mesh, *sys3)
    got, ref, exact = clone_state(st), clone_state(st), f64_state(st)
    ca_basis_cuda(got, *ins, CA_CAP, CA_S)
    ca_basis(ref, *ins, CA_CAP, CA_S)
    ca_basis(exact, *(v.double() for v in ins), CA_CAP, CA_S)
    torch.cuda.synchronize()
    outs_b = ("Y", "Yt", "parts")
    eb = {k: (rel_err(got[k], exact[k])[1], rel_err(ref[k], exact[k])[1])
          for k in outs_b}
    db = max(rel_err(got[k], ref[k])[0] for k in outs_b)
    c.expect(all(a <= 2 * b + 1e-6 for a, b in eb.values()),
             f"K10b N={N} over {S} shards nx={nx} "
             f"({ca_cluster_plan(N // S, CA_S, nx=nx)}), {label} system: to the "
             "f64 step, kernel / plain "
             + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in eb.items())
             + " max|ref| (kernel <= 2x plain + 1e-6)")
    tot = mesh.psum(ref["parts"])
    got, ref2, exact = clone_state(ref), clone_state(ref), f64_state(ref)
    ca_coeff_step_cuda(got, tot, CA_CAP, tol0, "eta", CA_S)
    ca_coeff_step(ref2, tot, CA_CAP, tol0, "eta", CA_S)
    ca_coeff_step(exact, tot.double(), CA_CAP, tol0.double(), "eta", CA_S)
    torch.cuda.synchronize()
    outs_c = ("x", "r", "z", "p", "pkt", "scal")
    ec = {k: (rel_err(got[k], exact[k])[1], rel_err(ref2[k], exact[k])[1])
          for k in outs_c}
    dc = max(rel_err(got[k], ref2[k])[0] for k in outs_c)
    same = all(torch.equal(got[k], ref2[k]) for k in ("iters", "done"))
    c.expect(all(a <= 2 * b + 1e-6 for a, b in ec.values()) and same,
             f"K10b' (coefficient step) N={N} over {S} shards nx={nx}, {label} "
             "system: to the f64 step, kernel / plain "
             + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in ec.items())
             + f" max|ref| (kernel <= 2x plain + 1e-6); iters, done equal {same}")
    return db, dc


def ca_pcg_synthetic_checks(c, mesh, N: int, S: int, syn) -> None:
    """The s-step PCG through the kernels on the well-conditioned system
    against the same loop with the plain steps and against K2' (lam within
    2e-6, the same iterations, the exits before the cap; rnorm at 1e-4: the
    s-step r.r recurrence has a cancellation floor, and at 1e-5 on this
    system it never fires, ROADMAP.md queue 3)."""
    from mpcgpu_tpu_torch.ops.pcg_cuda import pcg_solve_cuda

    torch, nx = c.torch, syn[2].shape[-1]
    fixed = min(20, 2 * nx) // CA_S * CA_S
    for crit, tol, cap in (("eta", 0.0, fixed), ("eta", 1e-9, 167),
                           ("rnorm", 1e-4, 167)):
        a = ca_pcg_run(c, mesh, *syn, True, cap, tol, crit)
        b = ca_pcg_run(c, mesh, *syn, False, cap, tol, crit)
        k2p = pcg_solve_cuda(*syn, torch.zeros_like(syn[2]), max_iter=cap,
                             exit_tol=tol, exit_criterion=crit)
        torch.cuda.synchronize()
        ep, e2 = rel_err(a[0], b[0])[1], rel_err(a[0], k2p.lam)[1]
        ok = ep <= 2e-6 and e2 <= 2e-6 and a[1] == b[1]
        ok = ok and abs(a[1] - int(k2p.iters)) <= CA_S
        ok = ok and a[2] == b[2] == bool(k2p.converged) == (tol > 0.0)
        ok = ok and (tol == 0.0 or a[1] < cap)
        c.expect(ok, f"s-step PCG (K10b) N={N} over {S} shards nx={nx}, "
                 f"well-conditioned {crit} exit_tol={tol:g} cap={cap}: vs the "
                 f"plain steps {ep:.3e}, vs K2' {e2:.3e} (<= 2e-6); iterations "
                 f"K10b {a[1]}, plain {b[1]}, K2' {int(k2p.iters)} (within "
                 f"{CA_S}); converged {a[2]}")


# ---- the eleventh slice: every other kernel at nq = 3, 5; the instance axis --
SLICE_KERNELS = ("K5 build_kkt_cuda", "K2' pcg_solve_cuda", "K6 compute_dz_cuda",
                 "K7 pcr_solve_cuda", "K8a build_kkt_schur_batched",
                 "K8b pcg_solve_batched", "K8c compute_dz_batched",
                 "K3b line_search_merits_batched", "K9a build_kkt_schur_slab",
                 "K9b compute_dz_slab", "K9c line_search_merit_partials_slab",
                 "K10a pcg_slab_step_cuda", "K10b ca_basis_cuda",
                 "K10b' ca_coeff_step_cuda")
NQ_SINGLE_SIZES = {3: (16, 64), 5: (64, 512)}    # K5, K2', K6; K7 also N = 3
NQ_SHARDS = {3: ((64, 4),), 5: ((512, 8), (64, 4))}   # the first: the timed case
FLEET_INSTANCES = 4        # the fleet's instance axis (make_mesh(n_instance=4))
ROUTE_ENSEMBLE = 4         # runs of each nq = 5 route from 1-ulp trace changes
NQ_PATH = {3: dict(N=16, B=NQ_BATCH, updates=16, shards=(64, 4)),
           5: dict(N=N_MAIN, B=B_MAIN, updates=ROUTE_UPDATES, shards=(512, 8))}


def chain_batch(nq: int, B: int, N: int, torch, device):
    """B instances of the chain tracker's trace (N rows) plus numpy noise
    (sigma 0.01, seed 0), the same goal window, rho cycling through 1e-3 x
    (1, 2, 3, 4); f32 tensors on the card (batch_problem's for an arm)."""
    import numpy as np

    from mpcgpu_tpu_torch.track_chain import reference_trace

    xu, ee = reference_trace(chain_model(nq, torch, "cpu", torch.float64), N)
    xu = xu[None] + 0.01 * np.random.default_rng(0).standard_normal((B, N, 3 * nq))
    f = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)
    return (f(xu), f(xu[:, 0, :2 * nq]), f(np.broadcast_to(ee, (B, N, 6))),
            f(1e-3 * (1 + np.arange(B) % 4)))


def slice_kernel_checks(c) -> dict:
    """Phase 2d: every kernel beside K1-K4 at nq = 3 and 5 against its plain
    version on the card, with the tolerances of its nq = 7 check (phases 2,
    2b, 2c): K5 5e-5 max|ref| per block (both integrators); K2' lam bit for
    bit K2's and within 2e-6 of its plain version on synthetic_btd at nx;
    K6 1e-5 and bit for bit K2's fused dz and the earlier dz_kernel (K9b
    too); K7 1e-5 of the plain and f64
    solves on synthetic_btd; K8a-c and K3b at B = NQ_BATCH bit for bit the
    single kernels per instance, and B_PLAIN instances against the plain
    versions (K8b on synthetic systems); K9a-c against their plain versions
    and K1 / K6 / K3 on NQ_SHARDS; K10a, K10b and K10b' as phase 2c.
    Returns {nq: {kernel: max|d| against the plain version}} at N_MAIN,
    B = NQ_BATCH and the first case of NQ_SHARDS."""
    import numpy as np

    from mpcgpu_tpu_torch.config import CostConfig
    from mpcgpu_tpu_torch.ops.pcg import pcg_solve
    from mpcgpu_tpu_torch.ops.pcg_cuda import (compute_dz_cuda, compute_dz_plain,
                                               compute_dz_slab,
                                               compute_dz_slab_plain, pcg_dz_solve,
                                               pcg_solve_cuda)
    from mpcgpu_tpu_torch.ops.pcr import pcr_solve_refined
    from mpcgpu_tpu_torch.ops.pcr_cuda import pcr_plan, pcr_solve_cuda
    from mpcgpu_tpu_torch.parallel import KnotMesh
    from mpcgpu_tpu_torch.parallel.batched_cuda import (
        build_kkt_schur_batched, build_kkt_schur_batched_plain, compute_dz_batched,
        compute_dz_batched_plain, line_search_merits_batched,
        line_search_merits_batched_plain, pcg_solve_batched,
        pcg_solve_batched_plain)
    from mpcgpu_tpu_torch.solver.kkt import build_kkt
    from mpcgpu_tpu_torch.solver.kkt_cuda import (build_kkt_cuda, build_kkt_schur,
                                                  build_kkt_schur_slab,
                                                  build_kkt_schur_slab_plain)
    from mpcgpu_tpu_torch.solver.merit import merit_partials
    from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merit_partials_slab,
                                                    line_search_merits_fused)

    torch, dev, expect = c.torch, c.dev, c.expect
    mu = 10.0
    errs = {nq: {k: 0.0 for k in SLICE_KERNELS} for nq in NQ_CASES}
    for nq in NQ_CASES:
        nx, w = 2 * nq, 3 * nq
        e = errs[nq]
        model = chain_model(nq, torch, dev)
        m64 = chain_model(nq, torch, dev, torch.float64)
        rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
        for N in NQ_SINGLE_SIZES[nq]:
            cost = CostConfig.for_knots(N)
            xu, xs, ee = chain_problem(nq, N, torch, dev)
            tag = f"nq={nq} N={N}"
            main_n = N == N_MAIN
            # K5 against build_kkt per block, within 5e-5 max|ref| (the nq =
            # 7 bound) or, where the plain f32 version is itself farther from
            # the f64 blocks (the defects c = x_k+1 - f(x_k, u_k) cancel: 6.4e-5
            # at nq = 5, N = 64), within 2x its distance to them
            for integ, wrap in ((0, False), (1, True)):
                c5 = cost if integ == 0 else dataclasses.replace(
                    cost, terminal_at_last_state=False)
                got5 = build_kkt_cuda(model, c5, xu, xs, ee, DT, integ, wrap)
                ref5 = build_kkt(model, c5, xu, xs, ee, DT, integ, wrap)
                f64_5 = build_kkt(m64, c5, xu.double(), xs.double(), ee.double(), DT,
                                  integ, wrap)
                torch.cuda.synchronize()
                rel, bad = {}, {}
                for k in ("Q", "q", "A", "B", "c", "R", "r"):
                    g_, r_, x_ = (getattr(t, k) for t in (got5, ref5, f64_5))
                    d, rel[k] = rel_err(g_, r_)
                    if main_n:
                        e["K5 build_kkt_cuda"] = max(e["K5 build_kkt_cuda"], d)
                    rk, rp = rel_err(g_, x_)[1], rel_err(r_, x_)[1]
                    if not (rel[k] <= 5e-5 or rk <= 2 * rp):
                        bad[k] = f"{rel[k]:.3e} (to f64 {rk:.3e}, plain {rp:.3e})"
                worst = max(rel, key=rel.get)
                expect(not bad, f"K5 {tag} integrator={integ} wrap={wrap}: worst "
                       f"block {worst} {rel[worst]:.3e} max|ref| (<= 5e-5, or within "
                       f"2x the plain f32 version's distance to f64); failing {bad}")
            sys_ = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0)
            lam0 = torch.zeros((N, nx), dtype=torch.float32, device=dev)
            u = xu[:, nx:]
            # K2' against K2 (the same template: lam bit for bit) and its
            # plain version on the well-conditioned system
            syn = dict(sys_)
            syn["S"], syn["Pinv"], syn["gamma"] = synthetic_btd(N, torch, dev, n=nx)
            for crit, tol, cap in (("eta", 0.0, min(20, 2 * N, 2 * nx)),
                                   ("eta", 1e-9, 167), ("rnorm", 1e-5, 167)):
                kw = dict(max_iter=cap, exit_tol=tol, exit_criterion=crit)
                k2 = pcg_dz_solve(syn, lam0, u, rho, cost.r_cost, **kw)
                k2p = pcg_solve_cuda(syn["S"], syn["Pinv"], syn["gamma"], lam0, **kw)
                ref = pcg_solve(syn["S"], syn["Pinv"], syn["gamma"], lam0, **kw)
                torch.cuda.synchronize()
                d, r = rel_err(k2p.lam, ref.lam)
                if main_n:
                    e["K2' pcg_solve_cuda"] = max(e["K2' pcg_solve_cuda"], d)
                same = (torch.equal(k2p.lam, k2[0]) and int(k2p.iters) == int(k2[2])
                        and bool(k2p.converged) == bool(k2[3]))
                expect(same and r <= 2e-6 and abs(int(k2p.iters) - int(ref.iters)) <= 2,
                       f"K2' {tag} well-conditioned {crit} exit_tol={tol:g} "
                       f"cap={cap}: lam, iters, exit bit for bit K2's {same}; vs "
                       f"plain {r:.3e} max|lam| (<= 2e-6), iters {int(k2p.iters)}, "
                       f"plain {int(ref.iters)}")
            # K6 on K1's blocks with K2's lam
            k2 = pcg_dz_solve(sys_, lam0, u, rho, cost.r_cost, max_iter=167,
                              exit_tol=1e-5)
            # (within 1e-5 max|ref|, the nq = 7 bound, or, where the plain
            # f32 version is itself farther from the f64 dz of the same
            # inputs: q - lam + A^T lam_+ cancels, 5.8e-5 at nq = 5, N = 512,
            # within 2x its distance)
            d6 = compute_dz_cuda(sys_, k2[0], u, rho, cost.r_cost)
            p6 = compute_dz_plain(sys_, k2[0], u, rho, cost.r_cost)
            x6 = compute_dz_plain({k: v.double() for k, v in sys_.items()},
                                  k2[0].double(), u.double(), rho.double(), cost.r_cost)
            torch.cuda.synchronize()
            d, r = rel_err(d6, p6)
            rk, rp = rel_err(d6, x6)[1], rel_err(p6, x6)[1]
            if main_n:
                e["K6 compute_dz_cuda"] = d
            expect((r <= 1e-5 or rk <= 2 * rp) and torch.equal(d6, k2[1]),
                   f"K6 {tag}: vs plain {r:.3e} max|ref| (<= 1e-5, or within 2x the "
                   f"plain f32 version's distance to f64: kernel {rk:.3e}, plain "
                   f"{rp:.3e}); bitwise equal to K2's fused dz {torch.equal(d6, k2[1])}")
            same = torch.equal(d6, dz_kernel_ref(torch, sys_, k2[0], u, rho, cost.r_cost))
            expect(same, f"K6 {tag}: bitwise equal to the earlier dz_kernel {same}")
        # K7 on the well-conditioned system, within 1e-5 of the plain and
        # the f64 solves
        for N in (3,) + NQ_SINGLE_SIZES[nq]:
            S7, _, b7 = synthetic_btd(N, torch, dev, n=nx)
            got = pcr_solve_cuda(S7, b7)
            ref = pcr_solve_refined(S7, b7)
            f64 = pcr_solve_refined(S7.double(), b7.double())
            torch.cuda.synchronize()
            (d, r), r64 = rel_err(got, ref), rel_err(got, f64)[1]
            if N == N_MAIN:
                e["K7 pcr_solve_cuda"] = d
            expect(r <= 1e-5 and r64 <= 1e-5,
                   f"K7 nq={nq} N={N} well-conditioned ({pcr_plan(N, nx)}): vs "
                   f"plain {r:.3e}, vs f64 {r64:.3e} max|x| (<= 1e-5)")

        # K8a-c and K3b at NQ_BATCH instances of N_MAIN knots
        N, B, P = N_MAIN, NQ_BATCH, B_PLAIN
        cost = CostConfig.for_knots(N)
        xu_b, xs_b, ee_b, rho_b = chain_batch(nq, B, N, torch, dev)
        lam0_b = torch.zeros((B, N, nx), dtype=torch.float32, device=dev)
        pcg_b = dict(max_iter=167, exit_tol=1e-5)
        sys_b = build_kkt_schur_batched(model, cost, xu_b, xs_b, ee_b, rho_b, DT)
        lam_b, it_b, cv_b = pcg_solve_batched(sys_b["S"], sys_b["Pinv"],
                                              sys_b["gamma"], lam0_b, **pcg_b)
        dz_b = compute_dz_batched(sys_b, lam_b, xu_b[:, :, nx:], rho_b, cost.r_cost)
        m_b, a_b = line_search_merits_batched(model, cost, xu_b, dz_b, xs_b, ee_b,
                                              mu, DT)
        torch.cuda.synchronize()
        differ = {"K8a": 0, "K8b": 0, "K8c": 0, "K3b": 0}
        for i in range(B):
            one = build_kkt_schur(model, cost, xu_b[i], xs_b[i], ee_b[i], rho_b[i],
                                  DT, 0)
            differ["K8a"] += not all(torch.equal(one[k], sys_b[k][i]) for k in one)
            one_i = {k: v[i] for k, v in sys_b.items()}
            p1 = pcg_solve_cuda(one_i["S"], one_i["Pinv"], one_i["gamma"],
                                lam0_b[i], **pcg_b)
            differ["K8b"] += not (torch.equal(p1.lam, lam_b[i])
                                  and torch.equal(p1.iters, it_b[i])
                                  and torch.equal(p1.converged, cv_b[i]))
            d1 = compute_dz_cuda(one_i, lam_b[i], xu_b[i, :, nx:], rho_b[i],
                                 cost.r_cost)
            differ["K8c"] += not torch.equal(d1, dz_b[i])
            m1, a1 = line_search_merits_fused(model, cost, xu_b[i], dz_b[i], xs_b[i],
                                              ee_b[i], mu, DT)
            differ["K3b"] += not (torch.equal(m1, m_b[i]) and torch.equal(a1, a_b[i]))
        expect(all(v == 0 for v in differ.values()),
               f"K8a/K8b/K8c/K3b nq={nq} B={B} N={N}: instances that differ from "
               f"the single kernels (K1/K2'/K6/K3) bit for bit: {differ}; PCG "
               f"iterations {int(it_b.min())}..{int(it_b.max())}")
        ref_b = build_kkt_schur_batched_plain(model, cost, xu_b[:P], xs_b[:P],
                                              ee_b[:P], rho_b[:P], DT)
        worst = 0.0
        for key in ref_b:
            d, r = rel_err(sys_b[key][:P], ref_b[key])
            e["K8a build_kkt_schur_batched"] = max(e["K8a build_kkt_schur_batched"], d)
            worst = max(worst, max(rel_err(sys_b[key][i], ref_b[key][i])[1]
                                   for i in range(P)))
        expect(worst <= 5e-5, f"K8a nq={nq} B={P}: vs plain per instance and "
               f"output, worst {worst:.3e} max|ref| (<= 5e-5)")
        syn = [synthetic_btd(N, torch, dev, seed=1 + i, n=nx) for i in range(P)]
        Sy, Py, gy = (torch.stack([t[j] for t in syn]) for j in range(3))
        for tol, cap in ((0.0, min(20, 2 * nx)), (1e-9, 167)):
            got = pcg_solve_batched(Sy, Py, gy, lam0_b[:P], max_iter=cap, exit_tol=tol)
            ref = pcg_solve_batched_plain(Sy, Py, gy, lam0_b[:P], max_iter=cap,
                                          exit_tol=tol)
            torch.cuda.synchronize()
            r = max(rel_err(got[0][i], ref[0][i])[1] for i in range(P))
            e["K8b pcg_solve_batched"] = max(e["K8b pcg_solve_batched"],
                                             rel_err(got[0], ref[0])[0])
            ik, ip = got[1].tolist(), ref[1].tolist()
            ok = ik == ip if tol == 0.0 else (
                all(abs(a - b) <= 2 for a, b in zip(ik, ip)) and bool(got[2].all()))
            expect(ok and r <= 2e-6, f"K8b nq={nq} B={P} well-conditioned "
                   f"exit_tol={tol:g} cap={cap}: lam vs plain {r:.3e} (<= 2e-6); "
                   f"iterations kernel {ik}, plain {ip}")
        d8 = compute_dz_batched_plain({k: v[:P] for k, v in sys_b.items()},
                                      lam_b[:P], xu_b[:P, :, nx:], rho_b[:P],
                                      cost.r_cost)
        m8, a8 = line_search_merits_batched_plain(model, cost, xu_b[:P], dz_b[:P],
                                                  xs_b[:P], ee_b[:P], mu, DT)
        torch.cuda.synchronize()
        d, r = rel_err(dz_b[:P], d8)
        e["K8c compute_dz_batched"] = d
        rel = float(((m_b[:P].double() - m8.double()).abs() / m8.double().abs()).max())
        e["K3b line_search_merits_batched"] = float(
            (m_b[:P].double() - m8.double()).abs().max())
        expect(r <= 1e-5 and rel <= 1e-4 and torch.equal(a_b[:P], a8),
               f"K8c / K3b nq={nq} B={P}: dz vs plain {r:.3e} max|ref| (<= 1e-5); "
               f"merits max relative error {rel:.3e} (<= 1e-4), alphas equal "
               f"{torch.equal(a_b[:P], a8)}")

        # the slab kernels over virtual shards
        for case, (N, S) in enumerate(NQ_SHARDS[nq]):
            L, rec = N // S, case == 0
            tag = f"nq={nq} N={N} over {S} shards"
            cost = CostConfig.for_knots(N)
            xu, xs, ee = chain_problem(nq, N, torch, dev)
            wins = knot_windows(c, N, S, -2, 2)
            first, last = (wins == 0).float(), (wins == N - 1).float()
            xe, ee_x = xu[wins].contiguous(), ee[wins].contiguous()
            for integ, c9 in ((0, cost), (1, dataclasses.replace(
                    cost, terminal_at_last_state=False))):
                got = build_kkt_schur_slab(model, c9, xe, ee_x, first, last, rho, DT,
                                           integ)
                ref = build_kkt_schur_slab_plain(model, c9, xe, ee_x, first, last,
                                                 rho, DT, integ)
                k1 = build_kkt_schur(model, c9, xu, xs, ee, rho, DT, integ)
                torch.cuda.synchronize()
                worst = max(rel_err(got[k], ref[k])[1] for k in got)
                if rec:
                    e["K9a build_kkt_schur_slab"] = max(
                        e["K9a build_kkt_schur_slab"],
                        *(rel_err(got[k], ref[k])[0] for k in got))
                same = all(torch.equal(got[k][:, 2:2 + L].reshape(k1[k].shape), k1[k])
                           for k in got)
                expect(worst <= 5e-5 and same,
                       f"K9a {tag}, integrator={integ}: vs plain per output, worst "
                       f"{worst:.3e} max|ref| (<= 5e-5); interior rows == K1 bit "
                       f"for bit {same}")
            k1 = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0)
            sl = {k: v[:, 2:2 + L] for k, v in build_kkt_schur_slab(
                model, cost, xe, ee_x, first, last, rho, DT).items()}
            lam = pcg_solve_cuda(k1["S"], k1["Pinv"], k1["gamma"],
                                 torch.zeros_like(k1["gamma"]), max_iter=20,
                                 exit_tol=0.0).lam
            lam_s, lam_n = shard_slabs(lam, S), shard_slabs(torch.roll(lam, -1, 0), S)
            last_s = shard_slabs((torch.arange(N, device=dev) == N - 1).float(), S)
            u_s = shard_slabs(xu, S)[..., nx:]
            d9 = compute_dz_slab(sl, lam_s, lam_n, last_s, u_s, rho, cost.r_cost)
            p9 = compute_dz_slab_plain(sl, lam_s, lam_n, last_s, u_s, rho, cost.r_cost)
            d6 = compute_dz_cuda(k1, lam, xu[:, nx:], rho, cost.r_cost)
            torch.cuda.synchronize()
            d, r = rel_err(d9, p9)
            if rec:
                e["K9b compute_dz_slab"] = d
            same = torch.equal(d9.reshape(N, w), d6)
            expect(r <= 1e-5 and same, f"K9b {tag}: vs plain {r:.3e} max|ref| "
                   f"(<= 1e-5); == K6 bit for bit {same}")
            same = torch.equal(d9, dz_slab_kernel_ref(torch, sl, lam_s, lam_n, last_s,
                                                      u_s, rho, cost.r_cost))
            expect(same, f"K9b {tag}: bitwise equal to the earlier dz_kernel {same}")
            w1 = knot_windows(c, N, S, 0, 1)
            x1, z1, e1 = xu[w1].contiguous(), d6[w1].contiguous(), ee[w1].contiguous()
            kc, kd, ka = line_search_merit_partials_slab(model, cost, x1, z1, e1, DT)
            pc, pd, pa = merit_partials(model, cost, x1, z1, e1, DT)
            m3 = line_search_merits_fused(model, cost, xu, d6, xs, ee, mu, DT)[0]
            torch.cuda.synchronize()
            (dc, rc), rd = rel_err(kc, pc), rel_err(kd, pd)[1]
            if rec:
                e["K9c line_search_merit_partials_slab"] = dc
            kc, kd = kc[..., :L], kd[..., :L]
            u_last = xu[-1, nx:] + ka[:, None] * d6[-1, nx:]
            x0 = (xu[0, :nx] + ka[:, None] * d6[0, :nx] - xs).abs().sum(-1)
            m9 = (kc.sum((0, 2)) - 0.5 * cost.r_cost * (u_last * u_last).sum(-1)) \
                + mu * ((kd.sum((0, 2)) - kd[-1, :, -1]) + x0)
            r3 = float(((m9.double() - m3.double()).abs() / m3.double().abs()).max())
            expect(rc <= 1e-4 and rd <= 1e-4 and torch.equal(ka, pa) and r3 <= 1e-4,
                   f"K9c {tag}: per-knot cost {rc:.3e}, defect {rd:.3e} max|ref| vs "
                   f"plain (<= 1e-4), alphas equal {torch.equal(ka, pa)}; assembled "
                   f"merits vs K3 {r3:.3e} (<= 1e-4)")
            mesh = KnotMesh(S)
            syn = synthetic_btd(N, torch, dev, n=nx)
            dp = k10a_synthetic_checks(c, mesh, N, S, syn)
            real = (k1["S"], k1["Pinv"], k1["gamma"])
            db, dcf = ca_step_checks(c, mesh, N, S, "real", real)
            ca_step_checks(c, mesh, N, S, "well-conditioned", syn)
            ca_pcg_synthetic_checks(c, mesh, N, S, syn)
            if rec:
                e["K10a pcg_slab_step_cuda"] = dp
                e["K10b ca_basis_cuda"], e["K10b' ca_coeff_step_cuda"] = db, dcf
    return errs


def fleet_starts(torch, dev, xs0, B: int):
    """simulate_mpc_ondevice_batched's draw of the starts: xs0 + 0.05
    N(0, 1) from a torch.Generator on the card seeded with 0."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return xs0 + 0.05 * torch.randn((B, xs0.shape[0]), generator=gen,
                                    dtype=torch.float32, device=dev)


def fleet_loop_checks(c, model, xu_tr, ee_tr, N: int, B: int, updates: int,
                      label: str, picks: int = BATCH_LOOP_PICKS, **kw) -> dict:
    """The batched closed loop (K8a-c, K3b, K4b) of B instances, unsharded
    and over make_mesh(n_instance=FLEET_INSTANCES): every instance's
    tracking errors and final error bit for bit equal, the launches (K8a-c,
    K3b once per batched SQP iteration of each group, K4b once per update
    and group), and ``picks`` instances bit for bit their single on-device
    loops from the same starts.  Returns the unsharded run's launches and
    a summary."""
    from mpcgpu_tpu_torch.config import SimConfig
    from mpcgpu_tpu_torch.parallel import make_mesh
    from mpcgpu_tpu_torch.sim.mpc import (simulate_mpc_ondevice,
                                          simulate_mpc_ondevice_batched)

    torch, dev, expect, counted = c.torch, c.dev, c.expect, c.counted
    sim = SimConfig(max_control_updates=updates)
    k8 = ("K8a build_kkt_schur_batched", "K8b pcg_solve_batched",
          "K8c compute_dz_batched", "K3b line_search_merits_batched")
    k4b = "K4b simulate_plant_batched"
    runs = {}
    for name, mesh in (("unsharded", None),
                       ("instance-sharded", make_mesh(n_instance=FLEET_INSTANCES))):
        runs[name] = counted(simulate_mpc_ondevice_batched, model, xu_tr, ee_tr, N,
                             DT, B, sim_cfg=sim, instance_mesh=mesh, **kw)
    (bl, n_bl), (sh, n_sh) = runs["unsharded"], runs["instance-sharded"]
    err = bl["tracking_errors"]
    spread = float(err[:, -1].max() - err[:, -1].min())
    ok = bool(torch.isfinite(err).all()) and tuple(err.shape) == (B, updates)
    ok = ok and bl["control_updates"] == updates and spread > 0
    for n, groups in ((n_bl, 1), (n_sh, FLEET_INSTANCES)):
        it = n[k8[0]]
        ok_n = all(n[k] == it for k in k8) and n[k4b] == groups * updates
        ok_n = ok_n and groups * updates <= it <= 2 * groups * updates
        ok_n = ok_n and all(v == 0 for k, v in n.items() if k not in k8 and k != k4b)
        expect(ok and ok_n,
               f"fleet {label} B={B} N={N} in {groups} instance group(s): "
               f"launches {n} (K8a-c, K3b once per batched SQP iteration of each "
               f"group, {it}; K4b once per update and group); errors "
               f"{tuple(err.shape)} finite; last-update spread over instances "
               f"{spread:.3e} (> 0); {int(bl['shift_mask'].sum())} shifts")
    same = all(torch.equal(sh[k], bl[k]) for k in
               ("tracking_errors", "shift_mask", "final_tracking_error"))
    expect(same, f"fleet {label}: make_mesh(n_instance={FLEET_INSTANCES}) == "
           f"unsharded, every instance's tracking errors and final error bit "
           f"for bit: {same}")
    starts = fleet_starts(torch, dev, torch.tensor(xu_tr[0, :model.nq * 2],
                                                   dtype=torch.float32, device=dev), B)
    differ = []
    pick = [i * (B - 1) // (picks - 1) for i in range(picks)]
    for i in pick:
        xu_i = xu_tr.copy()
        xu_i[0, :2 * model.nq] = starts[i].double().cpu().numpy()
        one = simulate_mpc_ondevice(model, xu_i, ee_tr, N, DT, sim_cfg=sim, **kw)
        if not (torch.equal(err[i][bl["shift_mask"]], one["tracking_errors"])
                and torch.equal(bl["final_tracking_error"][i],
                                one["final_tracking_error"])):
            differ.append(i)
    expect(not differ, f"fleet {label} vs single on-device loops of instances "
           f"{pick}: tracking errors and final error bit for bit; differing {differ}")
    return n_bl, dict(mean_tracking_error=float(err.mean()),
                      last_update_spread=spread, sqp_iterations=n_bl[k8[0]])


def spread_band(means) -> tuple:
    """The range of an ensemble's means widened on each side by its own
    ratio hi / lo: (lo^2 / hi, hi^2 / lo)."""
    lo, hi = min(means), max(means)
    return lo * lo / hi, hi * hi / lo


def nq_path_checks(c) -> tuple:
    """Phase 4g: the paths of every kernel beside K1-K4 at nq = 5 (full
    size) and 3 (N = 16): the fleet (B = NQ_PATH[nq]["B"] instances,
    unsharded and over the instance axis, instances against single loops),
    the knot-sharded fused SQP (pipelined_slab and the default ca_slab)
    against the single-device, plain and f64 solves as phase 4d, and the
    split routes and linsys="pcr_cuda" through the chain tracker's loop
    (fused_dz=False bit for bit the default route; at nq = 5 each route's
    band of ROUTE_ENSEMBLE runs from 1-ulp trace changes holds its plain
    f32 loop, "pcg" or "pcr" on the CPU, as phases 4 and 4b hold the
    IIWA's).  Returns {nq: {kernel: launches}} of these runs, and
    summaries."""
    import numpy as np

    from mpcgpu_tpu_torch import track_chain
    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
    from mpcgpu_tpu_torch.parallel import KnotMesh, sqp_solve_sharded
    from mpcgpu_tpu_torch.solver.sqp import sqp_solve

    torch, dev, expect, counted = c.torch, c.dev, c.expect, c.counted
    launches = {nq: {} for nq in NQ_CASES}
    out = {}
    for nq in NQ_CASES:
        p = NQ_PATH[nq]
        N, B, updates = p["N"], p["B"], p["updates"]
        model = chain_model(nq, torch, dev)
        xu_t, ee_t = track_chain.reference_trace(model, TRACK_STEPS)
        cost = track_chain.COST
        bl_kw = dict(cost=cost, sqp_cfg=track_chain.DEVICE_SQP, pcg_cfg=track_chain.PCG)
        n_fleet, fleet = fleet_loop_checks(c, model, xu_t, ee_t, N, B, updates,
                                           f"nq={nq}", **bl_kw)
        for k in SLICE_KERNELS[4:8] + ("K4b simulate_plant_batched",):
            launches[nq][k] = n_fleet[k]

        # the knot-sharded fused SQP on the arm's calm trace
        Ns, S = p["shards"]
        xu, xs, ee = chain_problem(nq, Ns, torch, dev)
        lam0 = torch.zeros((Ns, 2 * nq), dtype=torch.float32, device=dev)
        pcfg = PCGConfig(max_iter=PCGConfig.tuned_max_iter(Ns), exit_tol=1e-5)
        cap = pcfg.max_iter
        args = (CostConfig.for_knots(Ns), SQPConfig(max_iter=2), pcfg)
        m64 = chain_model(nq, torch, dev, torch.float64)
        one = sqp_solve(model, *args, xu, lam0, xs, ee, RHO0, DT, linsys="pcg_cuda")
        plain = sqp_solve(model, *args, xu, lam0, xs, ee, RHO0, DT, linsys="pcg",
                          merit_impl="plain")
        f64 = sqp_solve(m64, *args, xu.double(), lam0.double(), xs.double(),
                        ee.double(), RHO0, DT, linsys="pcg", merit_impl="plain")
        eo, ep = part_errs(one.xu, f64.xu, 2 * nq), part_errs(plain.xu, f64.xu, 2 * nq)
        k9 = [k for k in SLICE_KERNELS if k.startswith("K9")]
        for method, plain_method in (("pipelined_slab", "pipelined"), ("ca_slab", "ca")):
            sh, n_sh = counted(sqp_solve_sharded, model, *args, xu, lam0, xs, ee,
                               RHO0, DT, KnotMesh(S), pcg_method=method)
            sh_plain = sqp_solve_sharded(model, *args, xu, lam0, xs, ee, RHO0, DT,
                                         KnotMesh(S), fused=False,
                                         pcg_method=plain_method)
            torch.cuda.synchronize()
            it = int(sh.sqp_iters)
            want = {k: it for k in k9}
            if method == "pipelined_slab":
                want["K10a pcg_slab_step_cuda"] = it * (cap + 1)
            else:
                want.update({k: it * -(-cap // CA_S) for k in SLICE_KERNELS[-2:]})
            ok = all(n_sh[k] == want.get(k, 0) for k in n_sh)
            ok = ok and all(bool(torch.isfinite(t).all())
                            for t in (sh.xu, sh.lam, sh.rho, sh.merit))
            ok = ok and bool((sh.ls_alpha_idx >= 0).any())
            es, eq = part_errs(sh.xu, f64.xu, 2 * nq), part_errs(sh_plain.xu, f64.xu, 2 * nq)
            near = all(abs(a - b) <= CA_S for a, b in
                       zip(sh.pcg_iters.tolist(), one.pcg_iters.tolist()))
            dist_ok = all(es[k] <= 2 * max(eo[k], ep[k], eq[k]) + 1e-4 for k in es)
            expect(ok and near and dist_ok,
                   f"sharded SQP nq={nq} N={Ns} over {S} shards ({method}): "
                   f"launches {n_sh} (K9a-c once per SQP iteration, {it}; the PCG "
                   f"kernels per CG or outer step); finite; line search "
                   f"{sh.ls_alpha_idx.tolist()} (a step); PCG iterations "
                   f"{sh.pcg_iters.tolist()}, pcg_cuda {one.pcg_iters.tolist()} "
                   f"(within {CA_S}); to f64 per part {fmt(es)}, pcg_cuda "
                   f"{fmt(eo)}, plain {fmt(ep)}, plain sharded {fmt(eq)} (<= 2x "
                   f"max + 1e-4)")
            for k in want:
                launches[nq][k] = launches[nq].get(k, 0) + n_sh[k]

        # the split routes and pcr_cuda through the tracker's device loop
        routes = {"default": dict(),
                  "fused=False": dict(fused=False),
                  "fused_dz=False": dict(fused_dz=False),
                  "pcr_cuda": dict(linsys="pcr_cuda")}
        used = {"default": SLICE_KERNELS[:0],
                "fused=False": ("K5 build_kkt_cuda", "K2' pcg_solve_cuda"),
                "fused_dz=False": ("K2' pcg_solve_cuda", "K6 compute_dz_cuda"),
                "pcr_cuda": ("K5 build_kkt_cuda", "K7 pcr_solve_cuda")}
        loop = lambda trace, **kw: track_chain.track(
            model, trace, ee_t, N, ondevice=True, max_updates=updates, **kw)
        mean_err = lambda run: float(run["tracking_errors"].double().mean())
        runs = {name: counted(loop, xu_t, **kw) for name, kw in routes.items()}
        if nq == TRACK_NQ:
            rng = np.random.default_rng(6)
            xu32 = xu_t.astype(np.float32)
            moved = [np.nextafter(xu32, np.where(rng.random(xu32.shape) < 0.5, -np.inf,
                                                 np.inf).astype(np.float32))
                     .astype(np.float64) for _ in range(ROUTE_ENSEMBLE)]
            m_cpu = chain_model(nq, torch, "cpu")
            plain = {lin: mean_err(track_chain.track(
                m_cpu, xu_t, ee_t, N, ondevice=True, max_updates=updates, linsys=lin,
                merit_impl="plain")) for lin in ("pcg", "pcr")}
        for name, (run, n) in runs.items():
            its = int(run["sqp_iters"].sum())
            errs = run["tracking_errors"].double().cpu().numpy()
            ok = all(n[k] == its for k in used[name])
            ok = ok and n["K4 simulate_plant"] == updates
            ok = ok and all(v == 0 for k, v in n.items()
                            if k in SLICE_KERNELS and k not in used[name])
            ok = ok and bool(torch.isfinite(run["tracking_errors"]).all())
            m = float(errs.mean())
            rule = ""
            if nq == TRACK_NQ:
                lo, hi = spread_band([m] + [mean_err(loop(t, **routes[name]))
                                            for t in moved])
                yard = plain["pcr" if name == "pcr_cuda" else "pcg"]
                ok = ok and lo <= yard <= hi
                rule = (f"; its {ROUTE_ENSEMBLE} runs from 1-ulp trace changes and "
                        f"it: band {lo:.9g}..{hi:.9g} holds the plain f32 loop's "
                        f"{yard:.9g}")
            expect(ok, f"route {name} nq={nq} N={N}, {updates} updates: launches "
                   f"{n} ({list(used[name])} once per SQP iteration, {its}; K4 once "
                   f"per update); mean tracking error over {len(errs)} shifts "
                   f"{m:.9g}{rule}")
            for k in used[name]:
                launches[nq].setdefault(k, 0)
                launches[nq][k] += n[k]
        same = torch.equal(runs["fused_dz=False"][0]["xs_path"],
                           runs["default"][0]["xs_path"])
        expect(same, f"route fused_dz=False nq={nq} == the default route bit for "
               f"bit over {updates} updates (K2' lam and K6 dz equal K2's): {same}")
        out[nq] = dict(fleet=fleet)
    return launches, out


def slice_timings(c, launches: dict, errs: dict) -> dict:
    """Phase 5's times of every kernel beside K1-K4 at nq = 3 and 5, each
    beside its plain version and its bound at that nq: K5, K2', K6 and K7
    at N_MAIN (K7 on synthetic_btd, beside the dense library solves), K8a-c
    and K3b at NQ_BATCH instances, the slab kernels at the first case of
    NQ_SHARDS (plain, kernel, kernel, plain; the batched plain versions one
    call)."""
    import numpy as np

    from mpcgpu_tpu_torch import _kernels
    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig
    from mpcgpu_tpu_torch.ops.btd import btd_to_dense
    from mpcgpu_tpu_torch.ops.pcg import pcg_solve
    from mpcgpu_tpu_torch.ops.pcg_ca import ca_basis, ca_coeff_step
    from mpcgpu_tpu_torch.ops.pcg_ca_cuda import ca_basis_cuda, ca_coeff_step_cuda
    from mpcgpu_tpu_torch.ops.pcg_cuda import (compute_dz_cuda, compute_dz_plain,
                                               compute_dz_slab,
                                               compute_dz_slab_plain, pcg_dz_solve,
                                               pcg_solve_cuda)
    from mpcgpu_tpu_torch.ops.pcg_slab import pcg_slab_step, slab_state
    from mpcgpu_tpu_torch.ops.pcg_slab_cuda import pcg_slab_step_cuda
    from mpcgpu_tpu_torch.ops.pcr import pcr_solve_refined
    from mpcgpu_tpu_torch.ops.pcr_cuda import pcr_solve_cuda
    from mpcgpu_tpu_torch.parallel import KnotMesh
    from mpcgpu_tpu_torch.parallel.batched_cuda import (
        build_kkt_schur_batched, build_kkt_schur_batched_plain, compute_dz_batched,
        compute_dz_batched_plain, line_search_merits_batched,
        line_search_merits_batched_plain, pcg_solve_batched,
        pcg_solve_batched_plain)
    from mpcgpu_tpu_torch.solver.kkt import build_kkt
    from mpcgpu_tpu_torch.solver.kkt_cuda import (build_kkt_cuda, build_kkt_schur,
                                                  build_kkt_schur_slab,
                                                  build_kkt_schur_slab_plain)
    from mpcgpu_tpu_torch.solver.merit import merit_partials
    from mpcgpu_tpu_torch.solver.merit_cuda import line_search_merit_partials_slab

    torch, dev = c.torch, c.dev
    mu = 10.0
    rows = {}
    for nq in NQ_CASES:
        nx = 2 * nq
        model = chain_model(nq, torch, dev)
        rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
        tol0 = _kernels.scalar(0.0, dev)
        N = N_MAIN
        cost = CostConfig.for_knots(N)
        xu, xs, ee = chain_problem(nq, N, torch, dev)
        u = xu[:, nx:]
        sys_ = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0)
        lam0 = torch.zeros((N, nx), dtype=torch.float32, device=dev)
        pcg_kw = dict(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)
        lam_k2, _, k2_iters, _ = pcg_dz_solve(sys_, lam0, u, rho, cost.r_cost, **pcg_kw)
        k2p_iters = int(pcg_solve_cuda(sys_["S"], sys_["Pinv"], sys_["gamma"], lam0,
                                       **pcg_kw).iters)
        bounds = kernel_bounds(N, int(k2_iters), k2p_iters, 1, 1, nq=nq)
        S7, _, b7 = synthetic_btd(N, torch, dev, n=nx)
        bounds["K7 pcr_solve_cuda"] = pcr_bound(N, nq=nq)
        pairs = {
            "K5 build_kkt_cuda": (lambda: build_kkt_cuda(model, cost, xu, xs, ee, DT),
                                  lambda: build_kkt(model, cost, xu, xs, ee, DT)),
            "K2' pcg_solve_cuda": (
                lambda: pcg_solve_cuda(sys_["S"], sys_["Pinv"], sys_["gamma"], lam0,
                                       **pcg_kw),
                lambda: pcg_solve(sys_["S"], sys_["Pinv"], sys_["gamma"], lam0,
                                  **pcg_kw)),
            "K6 compute_dz_cuda": (
                lambda: compute_dz_cuda(sys_, lam_k2, u, rho, cost.r_cost),
                lambda: compute_dz_plain(sys_, lam_k2, u, rho, cost.r_cost)),
            "K7 pcr_solve_cuda": (lambda: pcr_solve_cuda(S7, b7),
                                  lambda: pcr_solve_refined(S7, b7)),
        }
        # K8a-c and K3b at NQ_BATCH instances (K8b from the cold start)
        B = NQ_BATCH
        xu_b, xs_b, ee_b, rho_b = chain_batch(nq, B, N, torch, dev)
        lam0_b = torch.zeros((B, N, nx), dtype=torch.float32, device=dev)
        sys_b = build_kkt_schur_batched(model, cost, xu_b, xs_b, ee_b, rho_b, DT)
        lam_b, it_b, _ = pcg_solve_batched(sys_b["S"], sys_b["Pinv"], sys_b["gamma"],
                                           lam0_b, **pcg_kw)
        u_b = xu_b[:, :, nx:]
        dz_b = compute_dz_batched(sys_b, lam_b, u_b, rho_b, cost.r_cost)
        bounds.update(batched_bounds(N, B, int((it_b.long() + 1).sum()), nq=nq))
        batched = {
            "K8a build_kkt_schur_batched": (
                lambda: build_kkt_schur_batched(model, cost, xu_b, xs_b, ee_b, rho_b, DT),
                lambda: build_kkt_schur_batched_plain(model, cost, xu_b, xs_b, ee_b,
                                                      rho_b, DT)),
            "K8b pcg_solve_batched": (
                lambda: pcg_solve_batched(sys_b["S"], sys_b["Pinv"], sys_b["gamma"],
                                          lam0_b, **pcg_kw),
                lambda: pcg_solve_batched_plain(sys_b["S"], sys_b["Pinv"],
                                                sys_b["gamma"], lam0_b, **pcg_kw)),
            "K8c compute_dz_batched": (
                lambda: compute_dz_batched(sys_b, lam_b, u_b, rho_b, cost.r_cost),
                lambda: compute_dz_batched_plain(sys_b, lam_b, u_b, rho_b, cost.r_cost)),
            "K3b line_search_merits_batched": (
                lambda: line_search_merits_batched(model, cost, xu_b, dz_b, xs_b, ee_b,
                                                   mu, DT),
                lambda: line_search_merits_batched_plain(model, cost, xu_b, dz_b, xs_b,
                                                         ee_b, mu, DT)),
        }
        # the slab kernels at the first shard case: K10a in its init mode (the
        # whole step's work, as phase 5), K10b and K10b' at the real system's
        # second outer step
        Ns, S = NQ_SHARDS[nq][0]
        L, cost_s = Ns // S, CostConfig.for_knots(Ns)
        xs_, xss, es_ = chain_problem(nq, Ns, torch, dev)
        wins = knot_windows(c, Ns, S, -2, 2)
        first, last = (wins == 0).float(), (wins == Ns - 1).float()
        xe, ee_x = xs_[wins].contiguous(), es_[wins].contiguous()
        k1 = build_kkt_schur(model, cost_s, xs_, xss, es_, rho, DT, 0)
        sl = {k: v[:, 2:2 + L] for k, v in build_kkt_schur_slab(
            model, cost_s, xe, ee_x, first, last, rho, DT).items()}
        lam = pcg_solve_cuda(k1["S"], k1["Pinv"], k1["gamma"],
                             torch.zeros_like(k1["gamma"]), max_iter=20,
                             exit_tol=0.0).lam
        lam_s, lam_n = shard_slabs(lam, S), shard_slabs(torch.roll(lam, -1, 0), S)
        last_s = shard_slabs((torch.arange(Ns, device=dev) == Ns - 1).float(), S)
        u_s = shard_slabs(xs_, S)[..., nx:]
        d6 = compute_dz_cuda(k1, lam, xs_[:, nx:], rho, cost_s.r_cost)
        w1 = knot_windows(c, Ns, S, 0, 1)
        x1, z1, e1 = xs_[w1].contiguous(), d6[w1].contiguous(), es_[w1].contiguous()
        mesh = KnotMesh(S)
        Sl, Pl, gl = (shard_slabs(k1[k], S) for k in ("S", "Pinv", "gamma"))
        PL, PR = mesh.send_right(Pl[:, -1]), mesh.send_left(Pl[:, 0])
        st = slab_state(torch.zeros_like(gl), gl)
        st_plain = clone_state(st)
        pk = torch.zeros((S, 6, nx), device=dev)
        k10 = lambda step, state: step(state, Sl, Pl, pk, pk, PL, PR, state["dots"],
                                       1, tol0, "eta", True)
        cst, ins = ca_setup_run(c, mesh, k1["S"], k1["Pinv"], k1["gamma"])
        tot = mesh.psum(cst["parts"])
        cst_k, cst_p = clone_state(cst), clone_state(cst)
        bounds.update(shard_bounds(Ns, S, nq=nq))
        bounds.update(ca_bounds(Ns, S, nq=nq))
        shards = {
            "K9a build_kkt_schur_slab": (
                lambda: build_kkt_schur_slab(model, cost_s, xe, ee_x, first, last, rho, DT),
                lambda: build_kkt_schur_slab_plain(model, cost_s, xe, ee_x, first, last,
                                                   rho, DT)),
            "K9b compute_dz_slab": (
                lambda: compute_dz_slab(sl, lam_s, lam_n, last_s, u_s, rho, cost_s.r_cost),
                lambda: compute_dz_slab_plain(sl, lam_s, lam_n, last_s, u_s, rho,
                                              cost_s.r_cost)),
            "K9c line_search_merit_partials_slab": (
                lambda: line_search_merit_partials_slab(model, cost_s, x1, z1, e1, DT),
                lambda: merit_partials(model, cost_s, x1, z1, e1, DT)),
            "K10a pcg_slab_step_cuda": (lambda: k10(pcg_slab_step_cuda, st),
                                        lambda: k10(pcg_slab_step, st_plain)),
            "K10b ca_basis_cuda": (lambda: ca_basis_cuda(cst_k, *ins, CA_CAP, CA_S),
                                   lambda: ca_basis(cst_p, *ins, CA_CAP, CA_S)),
            "K10b' ca_coeff_step_cuda": (
                lambda: ca_coeff_step_cuda(cst_k, tot, CA_CAP, tol0, "eta", CA_S),
                lambda: ca_coeff_step(cst_p, tot, CA_CAP, tol0, "eta", CA_S)),
        }
        print(f"  nq={nq}: K2' at the timed state {k2p_iters} PCG iterations; K8b "
              f"{int(it_b.min())}..{int(it_b.max())} over {B} instances; slab "
              f"kernels at N={Ns} over {S} shards")
        rows[nq] = {}
        for group, reps in ((pairs, 3), (batched, 0), (shards, 3)):
            for name, (kern, plain_fn) in group.items():
                if reps:
                    p1 = time_ms(torch, plain_fn, reps)
                    ms = statistics.median([graph_ms(torch, kern), graph_ms(torch, kern)])
                    plain_ms = statistics.median([p1, time_ms(torch, plain_fn, reps)])
                else:
                    ms = statistics.median([graph_ms(torch, kern, calls=5),
                                            graph_ms(torch, kern, calls=5)])
                    plain_ms = once_ms(torch, plain_fn)
                bound_ms, bound_by = bounds[name]
                rows[nq][name] = dict(launches=launches[nq].get(name, 0),
                                      max_abs_err=errs[nq][name], ms=ms,
                                      plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=bound_by, library_ms=None)
                print(f"  {name} nq={nq}: kernel {ms * 1e3:.1f} us (device), plain "
                      f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us "
                      f"({bound_by})")
        rows[nq]["K2' pcg_solve_cuda"]["us_per_iter"] = (
            rows[nq]["K2' pcg_solve_cuda"]["ms"] * 1e3 / max(k2p_iters, 1))
        rows[nq]["K8b pcg_solve_batched"]["us_per_iter"] = (
            rows[nq]["K8b pcg_solve_batched"]["ms"] * 1e3 / max(int(it_b.max()), 1))
        dense, rhs = btd_to_dense(S7), b7.reshape(-1, 1)
        lib = min(time_ms(torch, lambda: torch.linalg.solve_ex(dense, rhs), 5),
                  time_ms(torch, lambda: torch.cholesky_solve(
                      rhs, torch.linalg.cholesky_ex(dense).L), 5))
        rows[nq]["K7 pcr_solve_cuda"]["library_ms"] = lib
        print(f"  K7 nq={nq}: dense library solve {lib * 1e3:.1f} us")
    return rows


# ---- the twelfth slice: K6 and K9b a warp per knot, launched with PDL -----
RACE_CALLS = 16          # predecessor-then-dz pairs in one CUDA graph
# nq: (N of K1 -> K6, (N, shards) of K9a -> K9b)
RACE_CASES = {3: (16, (64, 4)), 5: (N_MAIN, (N_MAIN, 4)), 7: (N_MAIN, (N_BIG, 8))}


def dz_kernel_ref(torch, sys_, lam, u, rho, r_cost: float):
    """The earlier K6 on the same inputs: csrc/pcg_dz.cu::dz_kernel (a
    32-thread block per knot) through K8c's entry dz_launch at batch = 1;
    the bits the redesigned K6 keeps."""
    from mpcgpu_tpu_torch import _kernels

    N, nx = lam.shape
    dev = lam.device
    rho_t = _kernels.scalar(rho, dev)
    dz = torch.empty((N, nx + nx // 2), dtype=torch.float32, device=dev)
    _kernels.check(_kernels.entry("pcg_dz.cu", "dz_launch", nq=nx // 2)(
        lam.data_ptr(), sys_["Qinv"].data_ptr(), sys_["A"].data_ptr(),
        sys_["B"].data_ptr(), sys_["q"].data_ptr(), u.data_ptr(), u.stride(0), 0,
        rho_t.data_ptr(), float(r_cost), N, 1, dz.data_ptr(),
        _kernels.stream_ptr(dev)), "dz_launch")
    return dz


def dz_slab_kernel_ref(torch, sl, lam, lam_next, last, u, rho, r_cost: float):
    """The earlier K9b on the same inputs: dz_kernel through dz_slab_launch."""
    from mpcgpu_tpu_torch import _kernels

    S, L, nx = lam.shape
    dev = lam.device
    rho_t = _kernels.scalar(rho, dev)
    dz = torch.empty((S, L, nx + nx // 2), dtype=torch.float32, device=dev)
    _kernels.check(_kernels.entry("pcg_dz.cu", "dz_slab_launch", nq=nx // 2)(
        lam.data_ptr(), lam_next.data_ptr(), last.data_ptr(), sl["Qinv"].data_ptr(),
        sl["A"].data_ptr(), sl["B"].data_ptr(), sl["q"].data_ptr(),
        sl["Qinv"].stride(0) // (nx * nx), u.data_ptr(), u.stride(1), u.stride(0),
        rho_t.data_ptr(), float(r_cost), L, S, dz.data_ptr(),
        _kernels.stream_ptr(dev)), "dz_slab_launch")
    return dz


def dz_launch_raw(plan, pdl: int, args: tuple, dz):
    """dz_warp_launch by hand on a plan, with (pdl = 1) or without (0) the
    programmatic-stream-serialization attribute; args are the wrapper's
    arguments up to the batch (lam .. N, batch)."""
    from mpcgpu_tpu_torch import _kernels

    nq = dz.shape[-1] // 3
    _kernels.check(_kernels.entry("pcg_dz.cu", "dz_warp_launch", nq=nq)(
        *args, *plan, pdl, dz.data_ptr(), _kernels.stream_ptr(dz.device)),
        "dz_warp_launch")
    return dz


def dz_empty(dev, plan, batch: int, pdl: int, nq: int = 7) -> None:
    """The empty kernel on a dz plan's grid and block (the launch floor)."""
    from mpcgpu_tpu_torch import _kernels

    _kernels.check(_kernels.entry("pcg_dz.cu", "dz_empty_launch", nq=nq)(
        batch, *plan, pdl, _kernels.stream_ptr(dev)), "dz_empty_launch")


def split_route_order(c, model, cost, pcg_cfg, xu, ee) -> None:
    """The fused_dz=False route (K1 -> K2' -> K6) under torch.profiler: one
    sqp_solve of 2 SQP iterations from xu.  Every K6 launch must come right
    after a K2' launch in the stream (no cast or copy between them: K2''s
    exit flag is cast where the solve records it), and the results keep
    their dtypes (pcg_converged bool, pcg_iters int32)."""
    from torch.profiler import ProfilerActivity, profile

    from mpcgpu_tpu_torch.config import SQPConfig
    from mpcgpu_tpu_torch.solver.sqp import sqp_solve

    torch, expect = c.torch, c.expect
    nx = 2 * (xu.shape[1] // 3)
    run = lambda: sqp_solve(model, cost, SQPConfig(max_iter=2, max_time_us=None),
                            pcg_cfg, xu, torch.zeros_like(xu[:, :nx]), xu[0, :nx],
                            ee, RHO0, DT, linsys="pcg_cuda", fused_dz=False)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                 key=lambda e: e.time_range.start)
    names = [e.name for e in ops]
    k6 = [i for i, n in enumerate(names) if "dz_warp_kernel" in n]
    before = [names[i - 1] if i else "(none)" for i in k6]
    iters = int(res.sqp_iters)
    ok = (len(k6) == iters > 0 and all("pcg_dz_kernel" in b for b in before)
          and res.pcg_converged.dtype == torch.bool
          and res.pcg_iters.dtype == torch.int32)
    expect(ok, f"route fused_dz=False under the profiler: {len(names)} device "
           f"operations, {len(k6)} K6 launches ({iters} SQP iterations), each right "
           f"after {sorted(set(b[:60] for b in before))} (K2', pcg_dz_kernel); "
           f"pcg_converged {res.pcg_converged.dtype}, pcg_iters {res.pcg_iters.dtype}")


def dz_slice_timings(c, sys_, lam, u, rho, r_cost: float, exit_tol: float,
                     slab: dict, n_shard: int) -> dict:
    """Phase 5's numbers of this slice, device time per call of CUDA graphs
    of 20 calls, in two rounds (the second in reverse order), medians: K6
    (N knots) and K9b (``slab``, phase 2c's inputs) beside the earlier
    dz_kernel on the same inputs and beside themselves launched without
    programmatic dependent launch; the launch floor (the empty kernel on K6's
    and K9b's grids, with and without it); and the pairs on their routes:
    K2' from lam with no CG step (max_iter = 0: r0, z0 and the exit test)
    then K6 against K2' with its cast then dz_kernel, and the sharded step's
    halo glue then K9b against the glue then dz_kernel.  Returns {case:
    us}."""
    from mpcgpu_tpu_torch.ops.pcg_cuda import (compute_dz_cuda, compute_dz_slab,
                                               dz_plan, pcg_solve_cuda,
                                               pcg_solve_cuda_uncast)
    from mpcgpu_tpu_torch.parallel import KnotMesh
    from mpcgpu_tpu_torch.parallel.sqp_sharded import _next

    torch, dev = c.torch, c.dev
    N, nx = lam.shape
    plan6 = dz_plan(N, nx)
    lam_s, lam_n, last_s, u_s, sl = (slab[k] for k in ("lam_s", "lam_n", "last_s",
                                                       "u_s", "sl"))
    L = lam_s.shape[1]
    plan9 = dz_plan(L, nx)
    out6 = torch.empty((N, nx + nx // 2), device=dev)
    out9 = torch.empty((n_shard, L, nx + nx // 2), device=dev)
    args6 = (lam.data_ptr(), None, None, *(sys_[k].data_ptr() for k in ("Qinv", "A", "B", "q")),
             N, u.data_ptr(), u.stride(0), 0, rho.data_ptr(), float(r_cost), N, 1)
    args9 = (lam_s.data_ptr(), lam_n.data_ptr(), last_s.data_ptr(),
             *(sl[k].data_ptr() for k in ("Qinv", "A", "B", "q")),
             sl["Qinv"].stride(0) // (nx * nx), u_s.data_ptr(), u_s.stride(1),
             u_s.stride(0), rho.data_ptr(), float(r_cost), L, n_shard)
    mesh = KnotMesh(n_shard)
    k2p = lambda solve: solve(sys_["S"], sys_["Pinv"], sys_["gamma"], lam,
                              max_iter=0, exit_tol=exit_tol).lam
    glue = lambda: _next(lam_s, mesh.send_left(lam_s[:, 0]))
    cases = {
        f"K6 N={N}": lambda: compute_dz_cuda(sys_, lam, u, rho, r_cost),
        f"K6 N={N} without PDL": lambda: dz_launch_raw(plan6, 0, args6, out6),
        f"K6 N={N} earlier dz_kernel": lambda: dz_kernel_ref(torch, sys_, lam, u, rho,
                                                             r_cost),
        f"K9b {n_shard * L}/{n_shard}": lambda: compute_dz_slab(
            sl, lam_s, lam_n, last_s, u_s, rho, r_cost),
        f"K9b {n_shard * L}/{n_shard} without PDL": lambda: dz_launch_raw(
            plan9, 0, args9, out9),
        f"K9b {n_shard * L}/{n_shard} earlier dz_kernel": lambda: dz_slab_kernel_ref(
            torch, sl, lam_s, lam_n, last_s, u_s, rho, r_cost),
        "empty on K6's grid, PDL": lambda: dz_empty(dev, plan6, 1, 1),
        "empty on K6's grid, no PDL": lambda: dz_empty(dev, plan6, 1, 0),
        "empty on K9b's grid, PDL": lambda: dz_empty(dev, plan9, n_shard, 1),
        "empty on K9b's grid, no PDL": lambda: dz_empty(dev, plan9, n_shard, 0),
        "pair K2' -> K6": lambda: compute_dz_cuda(sys_, k2p(pcg_solve_cuda_uncast), u,
                                                  rho, r_cost),
        "pair K2' (cast) -> earlier dz_kernel": lambda: dz_kernel_ref(
            torch, sys_, k2p(pcg_solve_cuda), u, rho, r_cost),
        "pair glue -> K9b": lambda: compute_dz_slab(sl, lam_s, glue(), last_s, u_s,
                                                    rho, r_cost),
        "pair glue -> earlier dz_kernel": lambda: dz_slab_kernel_ref(
            torch, sl, lam_s, glue(), last_s, u_s, rho, r_cost),
    }
    got = {k: [] for k in cases}
    for order in (list(cases), list(cases)[::-1]):
        for k in order:
            got[k].append(graph_ms(torch, cases[k]) * 1e3)
    out = {k: statistics.median(v) for k, v in got.items()}
    for k, v in out.items():
        print(f"  {k}: {v:.3f} us (rounds {', '.join(f'{t:.3f}' for t in got[k])})")
    return out


def race_problem(nq: int, N: int, torch, dev, seed: int):
    """(model, xu, xs, ee) of N knots at nq joints: the IIWA on trace 0_0
    (problem()) at nq = 7, the chain tracker's arm (chain_problem()) else."""
    if nq == 7:
        from mpcgpu_tpu_torch.models import iiwa14

        return (iiwa14(torch.float32, device=dev),
                *problem(N, torch, dev, seed)[:3])
    return chain_model(nq, torch, dev), *chain_problem(nq, N, torch, dev, seed)


def dz_race_checks(c) -> None:
    """Phase 2e, the race check of K6 and K9b: K1 then K6 at once (and K9a
    then K9b), RACE_CALLS times in one CUDA graph, every pair on fresh
    blocks (the trace under another noise seed) that its predecessor has
    just written, every output of the graph set to NaN before the replay;
    then the same pairs eagerly on the stream.  Each dz must equal the
    earlier dz_kernel on its blocks bit for bit and lie within K6's bound of
    the plain version (1e-5 max|ref|, or 2x the plain f32 version's
    distance to f64, as phase 2d holds K6).  A load placed before
    griddepcontrol.wait would read NaN or another pair's blocks."""
    import numpy as np

    from mpcgpu_tpu_torch.config import CostConfig
    from mpcgpu_tpu_torch.ops.pcg_cuda import (compute_dz_cuda, compute_dz_plain,
                                               compute_dz_slab,
                                               compute_dz_slab_plain)
    from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur, build_kkt_schur_slab

    torch, dev, expect = c.torch, c.dev, c.expect
    rho = torch.full((), RHO0, device=dev)
    f64 = lambda d: {k: v.double() for k, v in d.items()}

    def held(dz, ref, plain, exact):
        r, rk, rp = rel_err(dz, plain)[1], rel_err(dz, exact)[1], rel_err(plain, exact)[1]
        return torch.equal(dz, ref) and (r <= 1e-5 or rk <= 2 * rp), r

    def run(pair, check, what):
        """pair(i) -> (the blocks its predecessor wrote, dz); check(i,
        blocks, dz) -> (held, its distance to the plain version)"""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [pair(i) for i in range(RACE_CALLS)]
        for blocks, dz in outs:
            for v in list(blocks.values()) + [dz]:
                v.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        res = [check(i, *o) for i, o in enumerate(outs)]
        eager = [check(i, *pair(i)) for i in range(RACE_CALLS)]
        n_g, n_e = sum(ok for ok, _ in res), sum(ok for ok, _ in eager)
        worst = max(e for _, e in res + eager)
        expect(n_g == n_e == RACE_CALLS,
               f"race {what}: {RACE_CALLS} pairs in one graph (outputs NaN before "
               f"the replay) / eagerly: dz == dz_kernel on the fresh blocks bit for "
               f"bit and within K6's bound of the plain version in {n_g} / {n_e} "
               f"(vs plain worst {worst:.3e} max|ref|)")

    for nq, (N, (Ns, S)) in RACE_CASES.items():
        nx, w = 2 * nq, 3 * nq
        rng = np.random.default_rng(5)
        # K1 -> K6
        cost = CostConfig.for_knots(N)
        probs = [race_problem(nq, N, torch, dev, seed) for seed in range(RACE_CALLS)]
        lam = torch.tensor(0.1 * rng.standard_normal((N, nx)), dtype=torch.float32,
                           device=dev)

        def k1_k6(i):
            model, xu, xs, ee = probs[i]
            sys_ = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0)
            return sys_, compute_dz_cuda(sys_, lam, xu[:, nx:], rho, cost.r_cost)

        def check_k6(i, sys_, dz):
            u = probs[i][1][:, nx:]
            return held(dz, dz_kernel_ref(torch, sys_, lam, u, rho, cost.r_cost),
                        compute_dz_plain(sys_, lam, u, rho, cost.r_cost),
                        compute_dz_plain(f64(sys_), lam.double(), u.double(),
                                         rho.double(), cost.r_cost))
        run(k1_k6, check_k6, f"K1 -> K6 nq={nq} N={N}")

        # K9a -> K9b on the shards' halo-extended windows
        L, cost_s = Ns // S, CostConfig.for_knots(Ns)
        win = torch.tensor((np.arange(S)[:, None] * L + np.arange(-2, L + 2)) % Ns,
                           device=dev)
        first, last = (win == 0).float(), (win == Ns - 1).float()
        probs_s = [race_problem(nq, Ns, torch, dev, seed) for seed in range(RACE_CALLS)]
        ext = [(m, xu[win].contiguous(), ee[win].contiguous(), xu.reshape(S, L, w)[..., nx:])
               for m, xu, _, ee in probs_s]
        lam_g = torch.tensor(0.1 * rng.standard_normal((Ns, nx)), dtype=torch.float32,
                             device=dev)
        lam_s = lam_g.reshape(S, L, nx)
        lam_n = torch.roll(lam_g, -1, 0).reshape(S, L, nx)
        last_s = (torch.arange(Ns, device=dev) == Ns - 1).float().reshape(S, L)

        def k9a_k9b(i):
            model, xe, ee_x, u_s = ext[i]
            out = build_kkt_schur_slab(model, cost_s, xe, ee_x, first, last, rho, DT)
            sl = {k: v[:, 2:2 + L] for k, v in out.items()}
            return out, compute_dz_slab(sl, lam_s, lam_n, last_s, u_s, rho, cost_s.r_cost)

        def check_k9b(i, out, dz):
            u_s = ext[i][3]
            sl = {k: v[:, 2:2 + L] for k, v in out.items()}
            return held(dz, dz_slab_kernel_ref(torch, sl, lam_s, lam_n, last_s, u_s,
                                               rho, cost_s.r_cost),
                        compute_dz_slab_plain(sl, lam_s, lam_n, last_s, u_s, rho,
                                              cost_s.r_cost),
                        compute_dz_slab_plain(f64(sl), lam_s.double(), lam_n.double(),
                                              last_s.double(), u_s.double(),
                                              rho.double(), cost_s.r_cost))
        run(k9a_k9b, check_k9b, f"K9a -> K9b nq={nq} N={Ns} over {S} shards")


def clone_state(st):
    return {k: v.clone() for k, v in st.items()}


def f64_state(st):
    """The state with every float tensor in f64 (the exact step's input)."""
    return {k: v.double() if v.is_floating_point() else v.clone()
            for k, v in st.items()}


def shard_slabs(t, S: int):
    """(N, ...) -> (S, N / S, ...): each shard's contiguous slab."""
    return t.reshape(S, t.shape[0] // S, *t.shape[1:])


def slab_pcg_run(c, mesh, SS, PP, gg, step, max_iter, exit_tol, exit_criterion="eta"):
    """The sharded pipelined slab PCG from lam = 0 with the given step
    (K10a's wrapper or its plain version): (lam, iters, converged)."""
    from mpcgpu_tpu_torch import _kernels
    from mpcgpu_tpu_torch.parallel.pcg_sharded import _pcg_local_pipelined_slab

    N, S = gg.shape[0], mesh.size
    lam, it, done = _pcg_local_pipelined_slab(
        shard_slabs(SS, S), shard_slabs(PP, S), shard_slabs(gg, S),
        shard_slabs(c.torch.zeros_like(gg), S), max_iter,
        _kernels.scalar(exit_tol, c.dev), mesh, exit_criterion, step=step)
    return lam.reshape(N, -1), int(it[0]), bool(done[0])


def ca_setup_run(c, mesh, SS, PP, gg):
    """The s-step state after one outer step of the plain version from lam
    = 0 (so g != 1), and K10b's inputs for the next: (st, (S, Pinv, SL, SR,
    PL, PR, fl, fr))."""
    from mpcgpu_tpu_torch import _kernels
    from mpcgpu_tpu_torch.ops.pcg_ca import ca_basis, ca_coeff_step, ca_state
    from mpcgpu_tpu_torch.parallel.pcg_sharded import _ca_halo_blocks, _ca_init

    S_ = mesh.size
    S_l, P_l, g_l = (shard_slabs(t, S_) for t in (SS, PP, gg))
    h = 2 * CA_S + 1
    blocks = (S_l, P_l, *_ca_halo_blocks(S_l, h, mesh),
              *_ca_halo_blocks(P_l, h, mesh))
    lam0 = c.torch.zeros_like(g_l)
    tol0 = _kernels.scalar(0.0, c.dev)
    st = ca_state(lam0, *_ca_init(S_l, P_l, g_l, lam0, mesh), tol0, "eta", CA_S)
    packets = lambda: (mesh.send_right(st["pkt"][:, 0]),
                       mesh.send_left(st["pkt"][:, 1]))
    ca_basis(st, *blocks, *packets(), CA_CAP, CA_S)
    ca_coeff_step(st, mesh.psum(st["parts"]), CA_CAP, tol0, "eta", CA_S)
    return st, blocks + packets()


def ca_pcg_run(c, mesh, SS, PP, gg, kernels, max_iter, exit_tol, exit_criterion="eta"):
    """The sharded s-step PCG from lam = 0 through K10b and the coefficient
    step (kernels) or their plain versions: (lam, iters, converged)."""
    from mpcgpu_tpu_torch import _kernels
    from mpcgpu_tpu_torch.ops.pcg_ca import ca_basis, ca_coeff_step
    from mpcgpu_tpu_torch.ops.pcg_ca_cuda import ca_basis_cuda, ca_coeff_step_cuda
    from mpcgpu_tpu_torch.parallel.pcg_sharded import _pcg_local_ca_slab

    N, S_ = gg.shape[0], mesh.size
    steps = (dict(basis=ca_basis_cuda, coeff=ca_coeff_step_cuda) if kernels
             else dict(basis=ca_basis, coeff=ca_coeff_step))
    lam, it, done = _pcg_local_ca_slab(
        shard_slabs(SS, S_), shard_slabs(PP, S_), shard_slabs(gg, S_),
        shard_slabs(c.torch.zeros_like(gg), S_), max_iter,
        _kernels.scalar(exit_tol, c.dev), mesh, exit_criterion, s_steps=CA_S, **steps)
    return lam.reshape(N, -1), int(it[0]), bool(done[0])


def kernel_wrappers() -> dict:
    """Each kernel's wrapper (KERNELS' order), whose .launches counts its
    launches."""
    from mpcgpu_tpu_torch.ops.pcg_ca_cuda import ca_basis_cuda, ca_coeff_step_cuda
    from mpcgpu_tpu_torch.ops.pcg_cuda import (compute_dz_cuda, compute_dz_slab,
                                               pcg_dz_solve, pcg_solve_cuda)
    from mpcgpu_tpu_torch.ops.pcg_slab_cuda import pcg_slab_step_cuda
    from mpcgpu_tpu_torch.ops.pcr_cuda import pcr_solve_cuda
    from mpcgpu_tpu_torch.parallel.batched_cuda import (build_kkt_schur_batched,
                                                        compute_dz_batched,
                                                        line_search_merits_batched,
                                                        pcg_solve_batched)
    from mpcgpu_tpu_torch.sim.plant_cuda import simulate_plant, simulate_plant_batched
    from mpcgpu_tpu_torch.solver.kkt_cuda import (build_kkt_cuda, build_kkt_schur,
                                                  build_kkt_schur_slab)
    from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merit_partials_slab,
                                                    line_search_merits_fused)

    return dict(zip(KERNELS, (build_kkt_schur, pcg_dz_solve,
                              line_search_merits_fused, simulate_plant,
                              build_kkt_cuda, pcg_solve_cuda, compute_dz_cuda,
                              pcr_solve_cuda, build_kkt_schur_batched,
                              pcg_solve_batched, compute_dz_batched,
                              line_search_merits_batched, build_kkt_schur_slab,
                              compute_dz_slab, line_search_merit_partials_slab,
                              pcg_slab_step_cuda, ca_basis_cuda,
                              ca_coeff_step_cuda, simulate_plant_batched)))


# ---- phase 4h: the last gaps to the JAX package ------------------------------

def gap_checks(c, model, main_run, band_400, xu_traj, ee_traj, xu_calm,
               ee_calm) -> dict:
    """Phase 4h.  (1) The main-path loop (phase 4's: N = N_MAIN, LOOP_UPDATES
    updates, K1-K4) at PCGConfig.tuned_max_iter_h100(N), its mean tracking
    error inside phase 4's band_400; K2's device time per call at the phase
    5 state, the loops' mean PCG iterations and us per update at both caps,
    in turns (where the table keeps the reference cap, one line says so and
    the second loop is skipped).  (2) pcg_solve(precond_poly=2) at f64 on
    synthetic_btd(N_MAIN) on the card: converged at rnorm 1e-10, within
    1e-8 max|x| of the dense solve on the CPU, in no more iterations than
    precond_poly=1.  (3) sqp_solve_batched_fused's merit_impl on phase 4e's
    first solve (B_MAIN instances from fleet_starts, one SQP iteration):
    "plain" launches K8a-c once and K3b never, "cuda" all four once; every
    instance takes the same line-search choice or one whose plain merit
    lies within that instance's kernel-vs-plain merit gap of the other
    (the f32 merits' own tie), and its xu is the same bits where the
    choices agree.  Returns the numbers for the results line."""
    import numpy as np

    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SimConfig, SQPConfig
    from mpcgpu_tpu_torch.ops.btd import btd_to_dense
    from mpcgpu_tpu_torch.ops.pcg import pcg_solve
    from mpcgpu_tpu_torch.ops.pcg_cuda import pcg_dz_solve
    from mpcgpu_tpu_torch.parallel.batched_cuda import (
        build_kkt_schur_batched, compute_dz_batched, line_search_merits_batched,
        line_search_merits_batched_plain, pcg_solve_batched, sqp_solve_batched_fused)
    from mpcgpu_tpu_torch.sim.mpc import simulate_mpc_ondevice
    from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur

    torch, dev, expect, counted = c.torch, c.dev, c.expect, c.counted
    N = N_MAIN
    cost = CostConfig.for_knots(N)
    card = card_line()
    out = {}

    # (1) the tuned cap on the main path
    cap_ref, cap_h100 = PCGConfig.tuned_max_iter(N), PCGConfig.tuned_max_iter_h100(N)
    out["caps"] = dict(reference=cap_ref, h100=cap_h100)
    k1_k4 = list(KERNELS)[:4]

    def loop_at(cap):
        return lambda k: simulate_mpc_ondevice(
            model, xu_traj, ee_traj, N, DT,
            sqp_cfg=SQPConfig(max_iter=2, max_time_us=None),
            pcg_cfg=PCGConfig(max_iter=cap, exit_tol=1e-5),
            sim_cfg=SimConfig(max_control_updates=k))

    def mean_iters(run):
        it = run["pcg_iters"]
        return float(it[it >= 0].double().mean())

    xu, xs, ee, _ = problem(N, torch, dev)
    rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
    sys_ = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0)
    lam0 = torch.zeros((N, 14), dtype=torch.float32, device=dev)

    def k2_call(cap):
        return lambda: pcg_dz_solve(sys_, lam0, xu[:, 14:], rho, cost.r_cost,
                                    max_iter=cap, exit_tol=1e-5)

    caps = (cap_ref,) if cap_h100 == cap_ref else (cap_ref, cap_h100)
    runs = {cap_ref: main_run}
    if cap_h100 == cap_ref:
        print(f"  the H100 table keeps the reference cap {cap_ref} at N={N}: no "
              f"second loop")
    else:
        runs[cap_h100], n_t = counted(loop_at(cap_h100), LOOP_UPDATES)
        run = runs[cap_h100]
        solves = int(run["sqp_iters"].sum())
        m = float(run["tracking_errors"].double().mean())
        ok = run["control_updates"] == LOOP_UPDATES
        ok = ok and n_t["K4 simulate_plant"] == LOOP_UPDATES
        ok = ok and all(n_t[k] == solves for k in k1_k4[:3])
        ok = ok and all(n_t[k] == 0 for k in KERNELS if k not in k1_k4)
        ok = ok and all(bool(torch.isfinite(run[k]).all())
                        for k in ("tracking_errors", "xs_path", "final_tracking_error"))
        expect(ok and band_400[0] <= m <= band_400[1],
               f"main path at the H100 cap {cap_h100} (reference {cap_ref}), "
               f"{LOOP_UPDATES} updates: launches {n_t} (K1-K3 once per SQP "
               f"iteration, {solves}; K4 once per update); mean tracking error "
               f"{m:.6g} (in phase 4's band {band_400[0]:.6g}..{band_400[1]:.6g})")
    # in turns: the reference cap, the tuned, the tuned, the reference
    order = caps + caps[::-1]
    k2_ms = {cap: [] for cap in caps}
    loop_us = {cap: [] for cap in caps}
    for cap in order:
        k2_ms[cap].append(graph_ms(torch, k2_call(cap)))
        loop_us[cap].append(slope_us(torch, loop_at(cap), *LOOP_SLOPE)[0])
    out["by_cap"] = {}
    for cap in caps:
        row = dict(k2_us_per_call=statistics.median(k2_ms[cap]) * 1e3,
                   k2_iters=int(k2_call(cap)()[2]),
                   loop_mean_pcg_iters=mean_iters(runs[cap]),
                   loop_mean_tracking_error=float(
                       runs[cap]["tracking_errors"].double().mean()),
                   loop_update_us=statistics.median(loop_us[cap]),
                   loop_update_us_runs=loop_us[cap])
        out["by_cap"][str(cap)] = row
        print(f"  cap {cap}: K2 {row['k2_us_per_call']:.1f} us per call (device, "
              f"{row['k2_iters']} CG iterations at the phase 5 state); the loop's "
              f"mean PCG iterations {row['loop_mean_pcg_iters']:.2f}, mean tracking "
              f"error {row['loop_mean_tracking_error']:.6g}, "
              f"{row['loop_update_us']:.1f} us per update (slope {LOOP_SLOPE}, "
              f"turns {', '.join(f'{v:.1f}' for v in loop_us[cap])}); {card}")

    # (2) precond_poly=2 at f64 on the card
    S, P, g = (t.double() for t in synthetic_btd(N, torch, dev))
    x_dense = np.linalg.solve(btd_to_dense(S.cpu()).numpy(),
                              g.cpu().numpy().ravel()).reshape(g.shape)
    poly = {p: pcg_solve(S, P, g, torch.zeros_like(g), max_iter=500, exit_tol=1e-10,
                         exit_criterion="rnorm", precond_poly=p) for p in (1, 2)}
    err = float(np.abs(poly[2].lam.cpu().numpy() - x_dense).max()
                / np.abs(x_dense).max())
    it1, it2 = int(poly[1].iters), int(poly[2].iters)
    out["precond_poly"] = dict(iters_1=it1, iters_2=it2, max_abs_err_rel=err)
    expect(bool(poly[2].converged) and err <= 1e-8 and it2 <= it1,
           f"pcg_solve(precond_poly=2), f64 on the card, synthetic_btd N={N}, rnorm "
           f"1e-10: converged {bool(poly[2].converged)} in {it2} iterations "
           f"(precond_poly=1: {it1}); vs the dense solve on the CPU {err:.3e} "
           f"max|x| (<= 1e-8)")

    # (3) the batched merit_impl on phase 4e's first solve
    B = B_MAIN
    window = lambda a: torch.tensor(a[:N], dtype=torch.float32,
                                    device=dev).expand(B, -1, -1).contiguous()
    xu_b, ee_b = window(xu_calm), window(ee_calm)
    xs_b = fleet_starts(torch, dev, xu_b[0, 0, :14], B)
    lam_b = torch.zeros((B, N, 14), dtype=torch.float32, device=dev)
    rho_b = torch.full((B,), RHO0, dtype=torch.float32, device=dev)
    args = (model, cost, SQPConfig(max_iter=1), PCGConfig(
        max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5),
        xu_b, lam_b, xs_b, ee_b, rho_b, DT)
    res, n_r = {}, {}
    for impl in ("plain", "cuda"):
        res[impl], n_r[impl] = counted(sqp_solve_batched_fused, *args, merit_impl=impl)
    k8 = ("K8a build_kkt_schur_batched", "K8b pcg_solve_batched",
          "K8c compute_dz_batched")
    k3b = "K3b line_search_merits_batched"
    expect(all(n_r[i][k] == 1 for i in n_r for k in k8)
           and n_r["plain"][k3b] == 0 and n_r["cuda"][k3b] == 1
           and all(v == 0 for i in n_r for k, v in n_r[i].items() if k not in k8 + (k3b,)),
           f"batched merit_impl, B={B}, one SQP iteration: launches plain "
           f"{n_r['plain']}, cuda {n_r['cuda']} (K8a-c once each; K3b 0 / 1)")
    # the merits of the step both solves took, by both routes
    sys_b = build_kkt_schur_batched(model, cost, xu_b, xs_b, ee_b, rho_b, DT)
    lam_n, _, _ = pcg_solve_batched(sys_b["S"], sys_b["Pinv"], sys_b["gamma"], lam_b,
                                    max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)
    dz_b = compute_dz_batched(sys_b, lam_n, xu_b[:, :, 14:], rho_b, cost.r_cost)
    mu = SQPConfig().mu
    mk, _ = line_search_merits_batched(model, cost, xu_b, dz_b, xs_b, ee_b, mu, DT)
    mp, _ = line_search_merits_batched_plain(model, cost, xu_b, dz_b, xs_b, ee_b, mu, DT)
    ck = res["cuda"].ls_alpha_idx[:, 0].long() + 1    # merit column (0: failed)
    cp = res["plain"].ls_alpha_idx[:, 0].long() + 1
    gap = (mk.double() - mp.double()).abs().amax(1)
    tie = (mp.double().gather(1, ck[:, None]) - mp.double().gather(1, cp[:, None])).abs()[:, 0]
    same = ck == cp
    ok_ties = bool((same | (tie <= gap)).all())
    xu_same = bool(torch.equal(res["cuda"].xu[same], res["plain"].xu[same]))
    out["merit_impl"] = dict(differing=int((~same).sum()),
                             max_merit_gap=float(gap.max()))
    expect(ok_ties and xu_same,
           f"batched merit_impl plain vs cuda, B={B}: line-search choices differ in "
           f"{int((~same).sum())} instance(s), each within its merits' own gap "
           f"(kernel vs plain, max {float(gap.max()):.3e}): {ok_ties}; xu bit for "
           f"bit where the choices agree ({int(same.sum())}): {xu_same}")
    return out


# ---- phase 4i: the flags of K3, K9a and K9c -----------------------------------

FLAG_K3_N = N_MAIN       # K3's flagged launches; K9a and K9c at SHARD_CASES


def wrap_problem(N: int, torch, device, seed: int = 0):
    """xu with joint angles 3.05 + 0.3 N(0, 1) and velocities and controls
    0.5 N(0, 1) (tests/test_angle_wrap.py::_problem's states: the
    integrated angles cross +-pi), xs = its first state, a goal N(0, 1) and
    a step 0.1 N(0, 1); f32 tensors on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = 3.05 + 0.3 * rng.standard_normal((N, 7))
    xu = np.concatenate([q, 0.5 * rng.standard_normal((N, 14))], axis=1)
    ee, dz = rng.standard_normal((N, 6)), 0.1 * rng.standard_normal((N, 21))
    f = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)
    return f(xu), f(xu[0, :14]), f(ee), f(dz)


def flag_checks(c, model) -> dict:
    """Phase 4i.  The JAX wrappers' flags through the kernels on states
    where the wrap fires (wrap_problem): each flagged launch against its
    plain version with the same flags at the bound phase 2 / 2c holds the
    kernel to (K3: merits 1e-4 relative, alphas equal; K9a: 5e-5 max|ref|
    per output; K9c: 1e-4 max|ref| per term, alphas equal), and against the
    kernel's own default launch, so that a flag that never reached the
    kernel fails: without the zero candidate the alphas, merits and terms
    are the default's from index 1 on, bit for bit; the wrap moves K3's
    merits, K9a's gamma (its other outputs bit for bit the unwrapped
    call's) and K9c's defects (its costs bit for bit).  K9a's interior rows
    equal K1's with the wrap bit for bit; K9c's terms, corrected at the
    global ends and summed, K3's merits with the same flags (1e-4).  Each
    flagged launch's device time (graph_ms) beside the default launch's,
    in turns (default, flagged, flagged, default).  Returns the times."""
    from mpcgpu_tpu_torch.config import CostConfig, SQPConfig
    from mpcgpu_tpu_torch.solver.kkt_cuda import (build_kkt_schur, build_kkt_schur_slab,
                                                  build_kkt_schur_slab_plain)
    from mpcgpu_tpu_torch.solver.merit import merit_partials
    from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merit_partials_slab,
                                                    line_search_merits_fused,
                                                    line_search_merits_plain)

    torch, dev, expect = c.torch, c.dev, c.expect
    mu = SQPConfig().mu
    card = card_line()
    out = {}

    def relm(a, b):
        return float(((a.double() - b.double()).abs() / b.double().abs()).max())

    def timed(label, default, flagged):
        t = {"default": [], "flagged": []}
        for which in ("default", "flagged", "flagged", "default"):
            t[which].append(graph_ms(torch, default if which == "default" else flagged)
                            * 1e3)
        row = {k: statistics.median(v) for k, v in t.items()}
        row["turns"] = t
        out[label] = row
        print(f"  {label}: {row['flagged']:.3f} us flagged, {row['default']:.3f} us "
              f"default (device, graph of 20 calls; turns flagged "
              f"{', '.join(f'{v:.3f}' for v in t['flagged'])}, default "
              f"{', '.join(f'{v:.3f}' for v in t['default'])}); {card}")

    # K3 at N = 64
    N = FLAG_K3_N
    cost = CostConfig.for_knots(N)
    xu, xs, ee, dz = wrap_problem(N, torch, dev)
    k3 = lambda **f: line_search_merits_fused(model, cost, xu, dz, xs, ee, mu, DT, **f)
    m_def, a_def = k3()
    for flags in (dict(include_zero=False), dict(angle_wrap=True)):
        m_k, a_k = k3(**flags)
        m_p, a_p = line_search_merits_plain(model, cost, xu, dz, xs, ee, mu, DT, **flags)
        torch.cuda.synchronize()
        rel = relm(m_k, m_p)
        if "include_zero" in flags:
            moved = (m_k.shape == (8,) and torch.equal(a_k, a_def[1:])
                     and torch.equal(m_k, m_def[1:]))
            how = "alphas and merits == the default's [1:] bit for bit"
        else:
            moved = relm(m_k, m_def) > 1e-4
            how = (f"merits moved {relm(m_k, m_def):.3e} relative from the "
                   f"default's (> 1e-4)")
        expect(rel <= 1e-4 and torch.equal(a_k, a_p) and moved,
               f"K3 N={N} {flags}: vs plain merits {rel:.3e} relative (<= 1e-4), "
               f"alphas equal {torch.equal(a_k, a_p)}; {how}: {moved}")
        timed(f"K3 N={N} {flags}", k3, lambda f=flags: k3(**f))

    for N, S in SHARD_CASES:
        L = N // S
        cost = CostConfig.for_knots(N)
        xu, xs, ee, dz = wrap_problem(N, torch, dev)
        rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
        # K9a with angle_wrap=True on the halo-extended windows
        w = knot_windows(c, N, S, -2, 2)
        first, last = (w == 0).float(), (w == N - 1).float()
        xe, ee_x = xu[w].contiguous(), ee[w].contiguous()
        k9a = lambda **f: build_kkt_schur_slab(model, cost, xe, ee_x, first, last,
                                               rho, DT, **f)
        got, plain = k9a(angle_wrap=True), k9a()
        ref = build_kkt_schur_slab_plain(model, cost, xe, ee_x, first, last, rho, DT,
                                         angle_wrap=True)
        k1 = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, angle_wrap=True)
        torch.cuda.synchronize()
        worst = max(rel_err(got[k], ref[k])[1] for k in got)
        same_k1 = all(torch.equal(got[k][:, 2:2 + L].reshape(k1[k].shape), k1[k])
                      for k in got)
        moved = rel_err(got["gamma"], plain["gamma"])[1]
        kept = all(torch.equal(got[k], plain[k]) for k in got if k != "gamma")
        expect(worst <= 5e-5 and same_k1 and moved > 5e-5 and kept,
               f"K9a N={N} over {S} shards, angle_wrap=True: vs plain per output, "
               f"worst {worst:.3e} max|ref| (<= 5e-5); interior rows == K1's with the "
               f"wrap bit for bit {same_k1}; gamma moved {moved:.3e} max|ref| from "
               f"the unwrapped call's (> 5e-5), its other outputs bit for bit {kept}")
        timed(f"K9a N={N}/{S} angle_wrap=True", k9a, lambda: k9a(angle_wrap=True))
        # K9c on each shard's L knots and the next shard's first
        w1 = knot_windows(c, N, S, 0, 1)
        x1, z1, e1 = xu[w1].contiguous(), dz[w1].contiguous(), ee[w1].contiguous()
        k9c = lambda **f: line_search_merit_partials_slab(model, cost, x1, z1, e1, DT,
                                                          **f)
        kc0, kd0, ka0 = k9c()
        kcw0, kdw0, _ = k9c(angle_wrap=True)
        for flags in (dict(include_zero=False), dict(angle_wrap=True),
                      dict(include_zero=False, angle_wrap=True)):
            kc, kd, ka = k9c(**flags)
            pc, pd, pa = merit_partials(model, cost, x1, z1, e1, DT, **flags)
            m3 = line_search_merits_fused(model, cost, xu, dz, xs, ee, mu, DT, **flags)[0]
            torch.cuda.synchronize()
            rc, rd = rel_err(kc, pc)[1], rel_err(kd, pd)[1]
            zero, wrap = flags.get("include_zero", True), flags.get("angle_wrap", False)
            drop = 1 - int(zero)
            # the default's candidates from index `drop` on, with the same wrap
            c_ref, d_ref = (kcw0, kdw0) if wrap else (kc0, kd0)
            shifted = (ka.shape == (8 + zero,) and torch.equal(ka, ka0[drop:])
                       and torch.equal(kc, c_ref[:, drop:]))
            d_same = torch.equal(kd, d_ref[:, drop:])
            d_moved = rel_err(kd, kd0[:, drop:])[1]
            moved = shifted and d_same and (not wrap or d_moved > 1e-4)
            kc_, kd_ = kc[..., :L], kd[..., :L]
            u_last = xu[-1, 14:] + ka[:, None] * dz[-1, 14:]
            x0 = (xu[0, :14] + ka[:, None] * dz[0, :14] - xs).abs().sum(-1)
            m9 = (kc_.sum((0, 2)) - 0.5 * cost.r_cost * (u_last * u_last).sum(-1)) \
                + mu * ((kd_.sum((0, 2)) - kd_[-1, :, -1]) + x0)
            r3 = relm(m9, m3)
            expect(rc <= 1e-4 and rd <= 1e-4 and torch.equal(ka, pa) and moved
                   and r3 <= 1e-4,
                   f"K9c N={N} over {S} shards {flags}: per-knot cost {rc:.3e}, "
                   f"defect {rd:.3e} max|ref| vs plain (<= 1e-4), alphas equal "
                   f"{torch.equal(ka, pa)}; alphas and costs == the default's "
                   f"[{drop}:] bit for bit {shifted}, defects == those of the call "
                   f"with the same wrap {d_same}, {d_moved:.3e} max|ref| from the "
                   f"unwrapped call's (> 1e-4 with the wrap): {moved}; "
                   f"assembled merits vs K3's with the flags {r3:.3e} (<= 1e-4)")
            timed(f"K9c N={N}/{S} {flags}", k9c, lambda f=flags: k9c(**f))
    return out


# ---- phase 4j: the SQP iteration as a CUDA graph ------------------------------
GRAPH_UPDATES = 64       # closed-loop updates held graph against eager
GRAPH_ROWS = (220, 420)  # trace 0_0's rows they track (the benchmark's calm rows)
# at N_BIG, trace 3_4's calm rows (SHARD_START; the benchmark's arm512-calm)
GRAPH_BIG_ROWS = (0, 650)
GRAPH_TIMED = 200        # chained 2-iteration solves timed each way
GRAPH_PROFILED = 10      # solves whose replays a profiler trace must hold


def graph_checks(c, model) -> dict:
    """Phase 4j.  The fused route's CUDA graph per SQP iteration
    (``solver/sqp_graph.py``) against the eager body (``sqp.graph_engages``
    patched to False): GRAPH_UPDATES updates of the on-device closed loop
    (plant and shift) at N_MAIN on trace 0_0's GRAPH_ROWS, every output bit
    for bit, on the K2 and the split (K2' -> K6) route, with every SQP
    iteration after the first capture a replay; the same at N_BIG on trace
    3_4's GRAPH_BIG_ROWS (K2's non-portable 16-CTA cluster of 32 knots a
    CTA, captured); a result unchanged after later solves; GRAPH_TIMED
    chained solves each way at N_MAIN and at N_BIG (host clock to a
    synchronize, median us a solve) and the host us of a replay (the
    ``sqp.replay`` spans of 20 traced solves); K1, K2 and K3 by name in
    a torch.profiler trace of GRAPH_PROFILED solves' replays, one launch
    each per SQP iteration, less at most a tenth (in one run of the whole
    smoke test the trace of 3 solves held 5 of 6 of each: the profiler
    drops a record now and then, as ``portbench/metrics/k2_roofline.py``
    notes).
    Returns the times."""
    from torch.profiler import ProfilerActivity, profile

    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SimConfig, SQPConfig
    from mpcgpu_tpu_torch.sim.mpc import simulate_mpc_ondevice
    from mpcgpu_tpu_torch.solver import sqp, sqp_graph
    from mpcgpu_tpu_torch.utils import profiling
    from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

    torch, dev, expect = c.torch, c.dev, c.expect
    sqp_cfg = SQPConfig(max_iter=2, max_time_us=None)
    cfgs = lambda N: (CostConfig.for_knots(N),
                      PCGConfig(max_iter=PCGConfig.tuned_max_iter(N)))
    cost, pcg_cfg = cfgs(N_MAIN)
    engages = sqp.graph_engages

    def eager(fn):
        sqp.graph_engages = lambda *a: False
        try:
            return fn()
        finally:
            sqp.graph_engages = engages

    out = {}
    loops = ((N_MAIN, "0_0", GRAPH_ROWS), (N_BIG, "3_4", GRAPH_BIG_ROWS))
    for (N, trace, rows), fused_dz in itertools.product(loops, (True, False)):
        sqp_graph.clear()
        xu_tr = load_xu_traj(trace)[rows[0]:rows[1]]
        ee_tr = load_eepos_traj(trace)[rows[0]:rows[1]]
        run = lambda: simulate_mpc_ondevice(
            model, xu_tr, ee_tr, N, DT, cost=cfgs(N)[0], sqp_cfg=sqp_cfg,
            pcg_cfg=cfgs(N)[1], sim_cfg=SimConfig(max_control_updates=GRAPH_UPDATES),
            linsys="pcg_cuda", fused_dz=fused_dz)
        with profiling.trace():
            got = run()
            torch.cuda.synchronize()
        n = profiling.counters()
        want = eager(run)
        diff = [k for k, v in want.items()
                if not (torch.equal(v, got[k]) if isinstance(v, torch.Tensor)
                        else v == got[k])]
        expect(not diff and n["sqp.captures"] == 1
               and n["sqp.replays"] + 1 == n["pcg.solves"]
               == int((want["pcg_iters"] >= 0).sum()),
               f"graph N={N} fused_dz={fused_dz}: {GRAPH_UPDATES} closed-loop updates "
               f"bit for bit against the eager body (differ: {diff or 'none'}); "
               f"{n['sqp.captures']} capture, {n['sqp.replays']} replays of "
               f"{n['pcg.solves']} SQP iterations")

    xu, xs, ee, _ = problem(N_MAIN, torch, dev, 0, GRAPH_ROWS[0])
    lam0 = torch.zeros((N_MAIN, 14), dtype=torch.float32, device=dev)
    solve = sqp.make_sqp_solver(model, cost, sqp_cfg, pcg_cfg, DT, linsys="pcg_cuda")
    first = solve(xu, lam0, xs, ee, RHO0)
    kept = [t.clone() for t in first]
    r = first
    for _ in range(8):
        r = solve(r.xu, r.lam, xs, ee, r.rho)
    torch.cuda.synchronize()
    expect(all(torch.equal(a, b) for a, b in zip(first, kept)),
           "graph: a result is unchanged after 8 later solves")

    def chained(solve, first, xs, ee):
        r, times = first, []
        for _ in range(GRAPH_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = solve(r.xu, r.lam, xs, ee, r.rho)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e6)
        return statistics.median(times)

    xu_b, xs_b, ee_b, _ = problem(N_BIG, torch, dev, 0, GRAPH_BIG_ROWS[0], "3_4")
    solve_b = sqp.make_sqp_solver(model, cfgs(N_BIG)[0], sqp_cfg, cfgs(N_BIG)[1],
                                  DT, linsys="pcg_cuda")
    first_b = solve_b(xu_b, torch.zeros((N_BIG, 14), dtype=torch.float32,
                                        device=dev), xs_b, ee_b, RHO0)
    for N, args in ((N_MAIN, (solve, first, xs, ee)),
                    (N_BIG, (solve_b, first_b, xs_b, ee_b))):
        tag = "" if N == N_MAIN else f" N={N}"
        for turn in ("graph", "eager", "eager", "graph"):
            us = chained(*args) if turn == "graph" else eager(lambda: chained(*args))
            out.setdefault(f"{turn} us a solve{tag}", []).append(us)
    with profiling.trace():
        r = first
        for _ in range(20):
            r = solve(r.xu, r.lam, xs, ee, r.rho)
        torch.cuda.synchronize()
    replays = [s.end_ns - s.start_ns for s in profiling.spans() if s.name == "sqp.replay"]
    out["replay host us (traced)"] = statistics.median(replays) / 1e3 if replays else None
    print(f"  graph: us a 2-iteration solve at N={N_MAIN} (median of {GRAPH_TIMED}, "
          f"turns graph, eager, eager, graph): graph "
          f"{out['graph us a solve']}, eager {out['eager us a solve']}; at "
          f"N={N_BIG}: graph {out[f'graph us a solve N={N_BIG}']}, eager "
          f"{out[f'eager us a solve N={N_BIG}']}; a replay's host us (median, "
          f"traced) {out['replay host us (traced)']}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r, iters = first, 0
        for _ in range(GRAPH_PROFILED):
            r = solve(r.xu, r.lam, xs, ee, r.rho)
            iters += int(r.sqp_iters)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    counts = {k: sum(k in nm for nm in names)
              for k in ("kkt_window_kernel", "pcg_dz_kernel", "merit_kernel")}
    least = iters - max(1, iters // 10)
    expect(all(least <= v <= iters for v in counts.values()),
           f"graph: a profiler trace of {GRAPH_PROFILED} solves ({iters} SQP "
           f"iterations, all replays) holds {counts} (one each per iteration; "
           f"at least {least}: the profiler now and then drops a record)")
    sqp_graph.clear()
    return out


# ---- phase 7: the multi-card path --------------------------------------------
MULTI_CARDS = 4           # the most cards phase 7 spreads over (one host)
# one wall limit for all of phase 7's workers (s), with one visible card
# and with more: a hang is the likely failure of a collective, and it fails
# the script
MULTI_TIMEOUT = (300, 900)
# the sharded solve's routes held bit for bit to the same solve on a
# one-card mesh of as many shards: (fused, pcg_method, preconditioner)
MULTI_ROUTES = tuple((True, m, "stair") for m in
                     ("classic", "pipelined_slab", "ca", "ca_slab")) + tuple(
    (False, m, "stair") for m in
    ("classic", "pipelined", "pipelined_slab", "ca", "ca_slab")) + (
    (False, "pipelined", "jacobi"), (False, "pipelined", "none"))
MULTI_METHODS = ("ca_slab", "pipelined_slab")   # the knot axis over every card
GRID_B = 8                 # the (instance, knot) grid's batch
ONE_CARD_UPDATES = 16      # the one-process mesh's loop (one visible card)
NCCL_CALLS = 200           # calls per timing of one collective
CHECKS_FAILED = 3          # a worker's exit code when it ran to its end with failed checks
GUARD_CALLS = 10_000       # entries of the card guard per timing


def shard_configs(N: int):
    """Phase 4d's configuration of the sharded solves and loops at N."""
    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig

    return (CostConfig.for_knots(N), SQPConfig(max_iter=2, max_time_us=None),
            PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5))


def nccl_packets(torch, dev, s: int = CA_S, nx: int = 14) -> dict:
    """One tensor per kind of collective the knot-sharded solves issue, at
    its size: name -> (send pair or all_reduce, tensor)."""
    from mpcgpu_tpu_torch.ops.pcg_ca import n_parts

    h = 2 * s + 1
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        f"K10b' packet, send pair (2, {h}, {nx}) f32":
            ("send", torch.ones((1, 2, h, nx), **f32)),
        f"K10a packet, send pair (6, {nx}) f32": ("send", torch.ones((1, 6, nx), **f32)),
        "K9a halo rows, send pair (2, 21) f32": ("send", torch.ones((1, 2, 21), **f32)),
        f"s-step halo blocks, send pair ({h}, 3, {nx}, {nx}) f32 (once a solve)":
            ("send", torch.ones((1, h, 3, nx, nx), **f32)),
        f"Gram parts, all_reduce ({n_parts(s)},) f64":
            ("psum", torch.ones((1, n_parts(s)), dtype=torch.float64, device=dev)),
        "K10a dots, all_reduce (3,) f32": ("psum", torch.ones((1, 3), **f32)),
        "merits, all_reduce (9,) f32": ("psum", torch.ones((1, 9), **f32)),
    }


def collective_us(torch, mesh, kind: str, x, calls: int = NCCL_CALLS) -> tuple:
    """(device us, host us) per call of one collective on mesh, over
    ``calls`` calls in a row after 10 warm ones: CUDA events on the current
    stream, which waits on each call's NCCL work."""
    fn = mesh.send_right if kind == "send" else mesh.psum
    for _ in range(10):
        fn(x)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(calls):
        fn(x)
    b.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / calls, host * 1e6 / calls


def multicard_checks(c) -> dict:
    """Phase 7 (module docstring): min(MULTI_CARDS, visible cards) worker
    processes of ``multicard_worker``, one per card, in one NCCL group on a
    localhost coordinator.  The kernels are built here first, so the
    workers only load them.  Every worker must exit 0 within
    MULTI_TIMEOUT; if one fails or the limit passes, every worker is killed
    and this raises.  Returns rank 0's summary, each kernel's count of the
    cards it ran on in this phase and every rank's check count."""
    import socket
    import tempfile

    from mpcgpu_tpu_torch import _kernels

    torch, expect = c.torch, c.expect
    _kernels.load([(src, _kernels.NQ_DEFAULT) for src in _kernels.SOURCES])
    world = min(MULTI_CARDS, torch.cuda.device_count())
    if world < 2:
        print(f"  {torch.cuda.device_count()} visible card: one worker in a world "
              "of 1 over NCCL; the 2- and 4-card checks need 2 or more visible "
              "cards (4 on one host for all of them)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    limit = MULTI_TIMEOUT[world > 1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multicard_") as tmp:
        tmp = Path(tmp)
        logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--multicard-worker",
             coord, str(world), str(r), str(tmp)],
            stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT)
            for r in range(world)]
        deadline = time.monotonic() + limit
        failed = None
        try:
            while failed is None:
                codes = [p.poll() for p in procs]
                if any(code not in (None, 0, CHECKS_FAILED) for code in codes):
                    failed = f"worker exit codes {codes} (None: still running)"
                elif all(code in (0, CHECKS_FAILED) for code in codes):
                    break
                elif time.monotonic() > deadline:
                    failed = (f"the workers ran past {limit} s: exit codes {codes} "
                              "(None: still running)")
                else:
                    time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for f in logs:
                f.close()
        texts = [(tmp / f"rank{r}.log").read_text() for r in range(world)]
        print(texts[0], end="")          # rank 0's checks and times in full
        for r, text in enumerate(texts[1:], 1):
            lines = text.splitlines()
            bad = [ln[:300] for ln in lines if ln.startswith("  FAIL")]
            print(f"  [rank {r}] checks passed "
                  f"{sum(ln.startswith('  ok') for ln in lines)}, failed "
                  f"{len(bad)}" + "".join(f"\n  {ln}" for ln in bad))
            if failed:
                print(f"---- rank {r}: last lines ----\n"
                      + "\n".join(lines[-20:]))
        if failed:
            raise SmokeFailure(f"phase 7: {failed}")
        results = [json.loads((tmp / f"rank{r}.json").read_text())
                   for r in range(world)]
    for res in results:
        expect(not res["failures"],
               f"phase 7 rank {res['rank']} on cuda:{res['card']} of {world}: "
               f"{res['checks']} checks, failed {res['failures'] or 'none'}")
    cards = {k: sum(1 for res in results if res["launches"][k] > 0) for k in KERNELS}
    return dict(world=world, cards=cards, summary=results[0]["summary"],
                checks=[res["checks"] for res in results],
                launches=results[0]["launches"],
                timings_by_rank=[res["summary"].get("timings") for res in results])


def multicard_worker(argv) -> int:
    """One process of phase 7: argv = (the coordinator "host:port", the
    world size, this rank, the directory for its results).  It finds its
    card through ``initialize_distributed`` (under test), runs the checks
    its world allows, writes rank<r>.json and exits with CHECKS_FAILED if
    a check failed."""
    coord, world, rank, out_dir = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
    from mpcgpu_tpu_torch.models import iiwa14
    from mpcgpu_tpu_torch.parallel import (KnotMesh, initialize_distributed,
                                           make_host_aligned_mesh, make_mesh,
                                           sqp_solve_batched_fused_sharded,
                                           sqp_solve_sharded)
    from mpcgpu_tpu_torch.sim.mpc import (simulate_mpc_ondevice,
                                          simulate_mpc_ondevice_batched)
    from mpcgpu_tpu_torch.sim.plant_cuda import simulate_plant
    from mpcgpu_tpu_torch.solver.sqp import sqp_solve
    from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

    initialize_distributed(coord, num_processes=world, process_id=rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    wrappers = kernel_wrappers()
    failures, n_checks = [], [0]
    total = {k: 0 for k in KERNELS}     # launches of the multi-card paths

    def expect(ok: bool, msg: str):
        n_checks[0] += 1
        print(("  ok   " if ok else "  FAIL ") + f"[rank {rank}] {msg}", flush=True)
        if not ok:
            failures.append(msg)

    def counted(fn, *args, **kw):
        """fn(*args, **kw) with every launch count set to 0 just before it;
        (result, the counts just after), added to this phase's total."""
        for w in wrappers.values():
            w.launches = 0
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        n = {k: w.launches for k, w in wrappers.items()}
        for k, v in n.items():
            total[k] += v
        return out, n

    def everywhere(t) -> bool:
        """Every rank of the world holds t's bits."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return all(torch.equal(p, parts[0]) for p in parts)

    def finite(*ts) -> bool:
        return all(bool(torch.isfinite(t).all()) for t in ts)

    def per_iter(mesh, before, n, it) -> dict:
        """Sends, psums and each kernel's launches per SQP iteration."""
        return dict(sends=(mesh.n_send - before[0]) / it,
                    psums=(mesh.n_psum - before[1]) / it,
                    launches={k.split()[0]: v / it for k, v in n.items() if v})

    visible = torch.cuda.device_count()
    model = iiwa14(torch.float32)            # the entry point's default device
    m64 = iiwa14(torch.float64)
    expect(dev.index == rank % visible and model.xc.device == dev
           and dist.get_backend() == "nccl",
           f"initialize_distributed made cuda:{dev.index} current ({visible} "
           f"visible, rank {rank} of {world}); iiwa14() on {model.xc.device}; "
           f"backend {dist.get_backend()}")
    summary = dict(world=world, card=dev.index)

    def setup(N):
        trace, start = SHARD_START[N]
        xu, xs, ee, _ = problem(N, torch, dev, 0, start, trace)
        lam0 = torch.zeros((N, 14), dtype=torch.float32, device=dev)
        xu_tr = load_xu_traj(trace)[start:start + N + LOOP_ROWS]
        ee_tr = load_eepos_traj(trace)[start:start + N + LOOP_ROWS]
        return (trace, start), (xu, lam0, xs, ee), (xu_tr, ee_tr)

    def loop(N, xu_tr, ee_tr, updates, **kw):
        cost, sqp, pcg = shard_configs(N)
        return simulate_mpc_ondevice(model, xu_tr, ee_tr, N, DT, cost=cost,
                                     sqp_cfg=sqp, pcg_cfg=pcg,
                                     sim_cfg=SimConfig(max_control_updates=updates),
                                     **kw)

    def held_to_one_card(mesh, N):
        """Every route of the sharded solve over ``mesh`` == the same solve
        on KnotMesh(mesh.size) on this card, bit for bit: a psum of one or
        two terms and a halo copy do not depend on where the shards are,
        and the bodies take their per-shard sums shard by shard
        (``parallel/pcg_sharded.py::_per_shard``)."""
        (trace, start), (xu, lam0, xs, ee), _ = setup(N)
        cost, sqp, pcg = shard_configs(N)
        rows = {}
        for fused, method, prec in MULTI_ROUTES:
            pc = dataclasses.replace(pcg, preconditioner=prec)
            before = (mesh.n_send, mesh.n_psum)
            got, n = counted(sqp_solve_sharded, model, cost, sqp, pc, xu, lam0, xs,
                             ee, RHO0, DT, mesh, fused=fused, pcg_method=method)
            ref = sqp_solve_sharded(model, cost, sqp, pc, xu, lam0, xs, ee, RHO0,
                                    DT, KnotMesh(mesh.size), fused=fused,
                                    pcg_method=method)
            torch.cuda.synchronize()
            it = int(got.sqp_iters)
            differ = [f for f in got._fields
                      if not torch.equal(getattr(got, f), getattr(ref, f))]
            route = f"{'fused' if fused else 'unfused'} {method} {prec}"
            rows[route] = per_iter(mesh, before, n, it)
            expect(not differ and finite(got.xu, got.lam),
                   f"N={N} over {mesh.size} card(s) ({trace} row {start}), {route}: "
                   f"== KnotMesh({mesh.size}) on one card bit for bit (differing "
                   f"{differ or 'none'}); per SQP iteration ({it}): {rows[route]}")
        return rows

    def knot_axis_checks(mesh):
        """The knot axis over every card: each solve held to the one-card
        pcg_cuda and f64 solves at phase 4d's bounds, every rank the same
        bits; the loops within phase 4d's band of the one-card loop."""
        out = {}
        for N in (N_BIG, N_MAIN):
            (trace, start), (xu, lam0, xs, ee), (xu_tr, ee_tr) = setup(N)
            args = shard_configs(N)
            one = sqp_solve(model, *args, xu, lam0, xs, ee, RHO0, DT, linsys="pcg_cuda")
            plain = sqp_solve(model, *args, xu, lam0, xs, ee, RHO0, DT, linsys="pcg",
                              merit_impl="plain")
            f64 = sqp_solve(m64, *args, xu.double(), lam0.double(), xs.double(),
                            ee.double(), RHO0, DT, linsys="pcg", merit_impl="plain")
            sh_plain = sqp_solve_sharded(model, *args, xu, lam0, xs, ee, RHO0, DT,
                                         KnotMesh(mesh.size), fused=False,
                                         pcg_method="pipelined")
            ca_plain = sqp_solve_sharded(model, *args, xu, lam0, xs, ee, RHO0, DT,
                                         KnotMesh(mesh.size), fused=False,
                                         pcg_method="ca")
            res, rows = {}, {}
            for method in MULTI_METHODS:
                before = (mesh.n_send, mesh.n_psum)
                res[method], n = counted(sqp_solve_sharded, model, *args, xu, lam0,
                                         xs, ee, RHO0, DT, mesh, pcg_method=method)
                rows[method] = per_iter(mesh, before, n, int(res[method].sqp_iters))
            e = {k: part_errs(r.xu, f64.xu) for k, r in
                 (("pcg_cuda", one), ("plain", plain), ("plain sharded", sh_plain),
                  ("plain s-step", ca_plain), *res.items())}
            ca, pl = res["ca_slab"], res["pipelined_slab"]
            near = all(abs(a - b) <= CA_S for a, b in
                       zip(ca.pcg_iters.tolist(), one.pcg_iters.tolist()))
            same_ls = ca.ls_alpha_idx.tolist() == one.ls_alpha_idx.tolist()
            for key in ("x", "u"):
                lim = 2 * max(e[k][key] for k in ("pcg_cuda", "plain",
                                                  "plain sharded")) + 1e-4
                expect(e["pipelined_slab"][key] <= lim,
                       f"N={N} over {mesh.size} card(s), pipelined_slab, {key} part: "
                       f"to f64 {e['pipelined_slab'][key]:.3e} (<= 2x max of "
                       f"pcg_cuda, plain, plain sharded + 1e-4 = {lim:.3e}); "
                       f"{fmt({k: v[key] for k, v in e.items()})}")
                lim_c = 2 * max(e[k][key] for k in e if k != "ca_slab") + 1e-4
                expect(near and same_ls and e["ca_slab"][key] <= lim_c,
                       f"N={N} over {mesh.size} card(s), ca_slab, {key} part: to f64 "
                       f"{e['ca_slab'][key]:.3e} (<= {lim_c:.3e}); PCG iterations "
                       f"{ca.pcg_iters.tolist()} (pcg_cuda {one.pcg_iters.tolist()}, "
                       f"within {CA_S}); line search {ca.ls_alpha_idx.tolist()} "
                       f"(pcg_cuda {one.ls_alpha_idx.tolist()})")
            for method, r in res.items():
                expect(everywhere(r.xu) and everywhere(r.lam) and finite(r.xu, r.lam)
                       and bool((r.ls_alpha_idx >= 0).any()),
                       f"N={N} over {mesh.size} card(s), {method}: every rank's xu and "
                       f"lam the same bits; finite; line search took "
                       f"{r.ls_alpha_idx.tolist()} (a step); per SQP iteration "
                       f"{rows[method]}")
            single = loop(N, xu_tr, ee_tr, SHARD_UPDATES)
            m_1 = float(single["tracking_errors"].double().mean())
            loops = {}
            for method in MULTI_METHODS:
                before = (mesh.n_send, mesh.n_psum)
                run, n = counted(loop, N, xu_tr, ee_tr, SHARD_UPDATES, knot_mesh=mesh,
                                 pcg_method=method)
                it = int(run["sqp_iters"].sum())
                m_ = float(run["tracking_errors"].double().mean())
                loops[method] = dict(mean_tracking_error=m_, sqp_iters=it,
                                     per_update=per_iter(mesh, before, n,
                                                         SHARD_UPDATES))
                expect(abs(m_ / m_1 - 1) <= 1e-2 and n["K4 simulate_plant"] == SHARD_UPDATES
                       and len(run["tracking_errors"]) == ROUTE_SHIFTS
                       and finite(run["tracking_errors"], run["xs_path"])
                       and everywhere(run["xs_path"])
                       and everywhere(run["tracking_errors"]),
                       f"loop N={N} over {mesh.size} card(s), {method}, {SHARD_UPDATES} "
                       f"updates: mean tracking error {m_:.6g} (within 1% of the "
                       f"one-card loop's {m_1:.6g}); every rank's path the same "
                       f"bits; {it} SQP iterations; per update {loops[method]['per_update']}")
            out[f"N={N} cards={mesh.size}"] = dict(
                trace=trace, start_row=start, solve_per_sqp_iter=rows,
                x_err={k: v["x"] for k, v in e.items()},
                u_err={k: v["u"] for k, v in e.items()},
                single_loop_mean_tracking_error=m_1, loops=loops)
        return out

    def other_card_checks():
        """Every kernel source launched on the tensors of another card
        while this process's card stays current: the same bits as on its
        own card (an entry launches in the current device's context)."""
        other = torch.device("cuda", (dev.index + 1) % visible)
        (trace, start), _, _ = setup(N_MAIN)
        args = shard_configs(N_MAIN)
        outs = {}
        for d in (dev, other):
            m_ = iiwa14(torch.float32, device=d)
            xu, xs, ee, _ = problem(N_MAIN, torch, d, 0, start, trace)
            lam0 = torch.zeros((N_MAIN, 14), dtype=torch.float32, device=d)
            solve = lambda **kw: sqp_solve(m_, *args, xu, lam0, xs, ee, RHO0, DT, **kw)
            sharded = lambda meth: sqp_solve_sharded(m_, *args, xu, lam0, xs, ee, RHO0,
                                                     DT, KnotMesh(4), pcg_method=meth)
            outs[d] = [solve(linsys="pcg_cuda").xu, solve(linsys="pcr_cuda").xu,
                       sharded("ca_slab").xu, sharded("pipelined_slab").xu,
                       simulate_plant(m_, xs, xu, 2e-3, 2e-3, DT, 10, 2e-4)]
        torch.cuda.synchronize(other)
        same = [torch.equal(a, b.to(dev)) for a, b in zip(outs[dev], outs[other])]
        expect(all(same) and torch.cuda.current_device() == dev.index
               and all(t.device == other for t in outs[other]),
               f"with cuda:{dev.index} current, pcg_cuda (K1-K3), pcr_cuda (K5, K7, "
               f"K3), ca_slab and pipelined_slab over KnotMesh(4) (K9a-c, K10a, K10b, "
               f"K10b') and K4 on cuda:{other.index}'s tensors == on cuda:{dev.index} "
               f"bit for bit {same}")

    def grid_checks(mesh):
        """The batched solve over the (instance, knot) grid: this rank's
        instance slab == the same rows of make_mesh(n_instance, n_knot) on
        one card, bit for bit."""
        N = N_MAIN
        xu_b, xs_b, ee_b, rho_b = batch_problem(GRID_B, N, torch, dev)
        cost, sqp, pcg = shard_configs(N)
        lam_b = torch.zeros((GRID_B, N, 14), dtype=torch.float32, device=dev)
        got, n = counted(sqp_solve_batched_fused_sharded, model, cost, sqp, pcg,
                         xu_b, lam_b, xs_b, ee_b, rho_b, DT, mesh)
        ref = sqp_solve_batched_fused_sharded(
            model, cost, sqp, pcg, xu_b, lam_b, xs_b, ee_b, rho_b, DT,
            make_mesh(mesh.n_instance, mesh.size))
        rows = mesh.instance_slices(GRID_B)[0]
        differ = [f for f in got._fields
                  if not torch.equal(getattr(got, f), getattr(ref, f)[rows])]
        expect(not differ and got.xu.shape[0] == GRID_B // mesh.n_instance,
               f"batched solve B={GRID_B} over the ({mesh.n_instance}, {mesh.size}) "
               f"grid: instances {rows.start}..{rows.stop - 1} == "
               f"make_mesh({mesh.n_instance}, {mesh.size}) on one card bit for bit "
               f"(differing {differ or 'none'}); launches "
               f"{ {k.split()[0]: v for k, v in n.items() if v} }")

    def fleet_checks(fleet):
        """The fleet over the instance axis: each card's instances of the
        B_MAIN loop == the same rows of the unsharded loop on this card."""
        xu_calm = load_xu_traj("0_0")[CALM_ROW:CALM_ROW + LOOP_ROWS]
        ee_calm = load_eepos_traj("0_0")[CALM_ROW:CALM_ROW + LOOP_ROWS]
        kw = dict(sqp_cfg=SQPConfig(max_iter=2),
                  pcg_cfg=PCGConfig(max_iter=PCGConfig.tuned_max_iter(N_MAIN),
                                    exit_tol=1e-5),
                  sim_cfg=SimConfig(max_control_updates=BATCH_UPDATES))
        mine, n = counted(simulate_mpc_ondevice_batched, model, xu_calm, ee_calm,
                          N_MAIN, DT, B_MAIN, instance_mesh=fleet, **kw)
        whole = simulate_mpc_ondevice_batched(model, xu_calm, ee_calm, N_MAIN, DT,
                                              B_MAIN, **kw)
        rows = fleet.instance_slices(B_MAIN)[0]
        same = torch.equal(mine["shift_mask"], whole["shift_mask"]) and all(
            torch.equal(mine[k], whole[k][rows])
            for k in ("tracking_errors", "final_tracking_error"))
        k8 = [k for k in KERNELS if k.startswith(("K8", "K3b"))]
        it = n[k8[0]]
        ok = all(n[k] == it for k in k8) and n["K4b simulate_plant_batched"] == BATCH_UPDATES
        ok = ok and tuple(mine["tracking_errors"].shape) == (
            B_MAIN // fleet.n_instance, BATCH_UPDATES)
        expect(same and ok and finite(mine["tracking_errors"]),
               f"fleet B={B_MAIN} N={N_MAIN} over {fleet.n_instance} card(s), "
               f"{BATCH_UPDATES} updates from row {CALM_ROW}: instances "
               f"{rows.start}..{rows.stop - 1} == the unsharded one-card loop's "
               f"bit for bit {same}; launches "
               f"{ {k.split()[0]: v for k, v in n.items() if v} } (K8a-c, K3b once "
               f"per batched SQP iteration, {it}; K4b once per update)")
        return dict(mean_tracking_error=float(mine["tracking_errors"].double().mean()),
                    sqp_iterations=it, instances=rows.stop - rows.start)

    def timings(mesh, fleet):
        """CUDA-event slopes, medians of 3 (phase 5's), on every card at once:
        the knot axis over all cards beside KnotMesh(W) and pcg_cuda on one
        card; the fleet beside one card's B_MAIN loop; one collective of
        each kind; the card guard's entry and exit on the host."""
        W = mesh.size
        out = {}
        for N in (N_BIG, N_MAIN):
            _, (xu, lam0, xs, ee), (xu_tr, ee_tr) = setup(N)
            cost, _, pcg = shard_configs(N)
            solve = lambda k, **kw: sqp_solve_sharded(
                model, cost, SQPConfig(max_iter=k), pcg, xu, lam0, xs, ee, RHO0,
                DT, **kw)
            row = {}
            for method in MULTI_METHODS:
                for name, m_ in (("cards", mesh), ("one_card_mesh", KnotMesh(W))):
                    it_us, it_runs = slope_us(torch, lambda k: solve(
                        k, mesh=m_, pcg_method=method), 1, 3)
                    upd_us, upd_runs = slope_us(torch, lambda k: loop(
                        N, xu_tr, ee_tr, k, knot_mesh=m_, pcg_method=method),
                        *SHARD_SLOPE)
                    row[f"{method} {name}"] = dict(
                        sqp_iter_us=it_us, sqp_iter_runs=it_runs, update_us=upd_us,
                        update_runs=upd_runs)
            it_us, it_runs = slope_us(torch, lambda k: sqp_solve(
                model, cost, SQPConfig(max_iter=k), pcg, xu, lam0, xs, ee, RHO0, DT,
                linsys="pcg_cuda"), 1, 3)
            upd_us, upd_runs = slope_us(torch, lambda k: loop(N, xu_tr, ee_tr, k),
                                        *SHARD_SLOPE)
            row["pcg_cuda one card"] = dict(sqp_iter_us=it_us, sqp_iter_runs=it_runs,
                                            update_us=upd_us, update_runs=upd_runs)
            out[f"N={N} cards={W}"] = row
            for name, r in row.items():
                print(f"  [rank {rank}] N={N}, {name}: {r['sqp_iter_us']:.1f} us per "
                      f"SQP iteration (runs {', '.join(f'{v:.1f}' for v in r['sqp_iter_runs'])}), "
                      f"{r['update_us']:.1f} us per update (runs "
                      f"{', '.join(f'{v:.1f}' for v in r['update_runs'])})", flush=True)
        xu_calm = load_xu_traj("0_0")[CALM_ROW:CALM_ROW + LOOP_ROWS]
        ee_calm = load_eepos_traj("0_0")[CALM_ROW:CALM_ROW + LOOP_ROWS]
        bl_kw = dict(sqp_cfg=SQPConfig(max_iter=2),
                     pcg_cfg=PCGConfig(max_iter=PCGConfig.tuned_max_iter(N_MAIN),
                                       exit_tol=1e-5))
        fl = {}
        # B_MAIN over the cards (B_MAIN / W a card), the same on one card, and
        # B_MAIN a card (W B_MAIN over the cards)
        for name, B, inst in (("cards", B_MAIN, fleet), ("one card", B_MAIN, None),
                              ("cards, B_MAIN a card", W * B_MAIN, fleet)):
            upd, runs = slope_us(torch, lambda k: simulate_mpc_ondevice_batched(
                model, xu_calm, ee_calm, N_MAIN, DT, B,
                sim_cfg=SimConfig(max_control_updates=k), instance_mesh=inst,
                **bl_kw), *BATCH_SLOPE)
            fl[name] = dict(batch=B, update_us=upd, runs=runs)
            print(f"  [rank {rank}] fleet B={B}, {name}: {upd:.1f} us per update "
                  f"(runs {', '.join(f'{v:.1f}' for v in runs)})", flush=True)
        out["fleet"] = fl
        coll = {}
        for name, (kind, x) in nccl_packets(torch, dev).items():
            runs = [collective_us(torch, mesh, kind, x) for _ in range(3)]
            coll[name] = dict(device_us=statistics.median(r[0] for r in runs),
                              host_us=statistics.median(r[1] for r in runs))
            print(f"  [rank {rank}] {name} over {W} cards: {coll[name]['device_us']:.2f} "
                  f"us (device), {coll[name]['host_us']:.2f} us (host) per call",
                  flush=True)
        x = torch.ones(3, device=dev)
        raw = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(NCCL_CALLS):
                dist.all_reduce(x)
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            raw.append(((time.perf_counter() - t0) * 1e6 / NCCL_CALLS,
                        host * 1e6 / NCCL_CALLS))
        coll["dist.all_reduce (3,) f32, no mesh"] = dict(
            wall_us=statistics.median(r[0] for r in raw),
            host_us=statistics.median(r[1] for r in raw))
        print(f"  [rank {rank}] dist.all_reduce (3,) f32 alone: "
              f"{coll['dist.all_reduce (3,) f32, no mesh']}", flush=True)
        out["collectives"] = coll
        t0 = time.perf_counter()
        for _ in range(GUARD_CALLS):
            with torch.cuda.device(dev):
                pass
        t1 = time.perf_counter()
        for _ in range(GUARD_CALLS):
            torch.cuda.current_device() == dev.index
        t2 = time.perf_counter()
        out["card_guard_host_us"] = (t1 - t0) * 1e6 / GUARD_CALLS
        out["current_card_test_host_us"] = (t2 - t1) * 1e6 / GUARD_CALLS
        print(f"  [rank {rank}] host time of the card guard (torch.cuda.device) "
              f"entered and left {out['card_guard_host_us']:.3f} us; of the test "
              f"that skips it on the current card {out['current_card_test_host_us']:.3f} "
              "us", flush=True)
        return out

    if world == 1:
        # the one-process mesh: its psum and gather go through NCCL
        mesh = make_host_aligned_mesh()
        summary["one_process_routes"] = held_to_one_card(mesh, N_MAIN)
        _, _, (xu_tr, ee_tr) = setup(N_MAIN)
        got, _ = counted(loop, N_MAIN, xu_tr, ee_tr, ONE_CARD_UPDATES,
                         knot_mesh=mesh, pcg_method="ca_slab")
        ref = loop(N_MAIN, xu_tr, ee_tr, ONE_CARD_UPDATES, knot_mesh=KnotMesh(1),
                   pcg_method="ca_slab")
        keys = ("tracking_errors", "xs_path", "sqp_iters", "pcg_iters")
        differ = [k for k in keys if not torch.equal(got[k], ref[k])]
        expect(not differ, f"loop N={N_MAIN} over the one-process mesh, ca_slab, "
               f"{ONE_CARD_UPDATES} updates: == KnotMesh(1) bit for bit (differing "
               f"{differ or 'none'})")
        summary["fleet"] = fleet_checks(make_host_aligned_mesh(1))
    else:
        other_card_checks()
        mesh2 = make_host_aligned_mesh(2)
        summary["two_rank_routes"] = {N: held_to_one_card(mesh2, N)
                                      for N in (N_MAIN, N_BIG)}
        if mesh2.n_instance > 1:
            grid_checks(mesh2)
        mesh = make_host_aligned_mesh()
        summary["knot_axis"] = knot_axis_checks(mesh)
        fleet = make_host_aligned_mesh(1)
        summary["fleet"] = fleet_checks(fleet)
        summary["timings"] = timings(mesh, fleet)
    dist.barrier()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(dict(
        rank=rank, card=dev.index, failures=failures, checks=n_checks[0],
        launches=total, summary=summary)))
    dist.destroy_process_group()
    return CHECKS_FAILED if failures else 0


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
    from mpcgpu_tpu_torch import track_chain, track_iiwa_qdldl
    from mpcgpu_tpu_torch.ops.btd import btd_matvec, btd_to_dense
    from mpcgpu_tpu_torch.ops.ldl import btd_ldl_solve
    from mpcgpu_tpu_torch.ops.pcg import pcg_solve
    from mpcgpu_tpu_torch.ops.pcr import pcr_solve_refined
    from mpcgpu_tpu_torch.ops.pcr_cuda import pcr_plan, pcr_solve_cuda
    from mpcgpu_tpu_torch.parallel import make_batched_sqp_solver
    from mpcgpu_tpu_torch.parallel.batched_cuda import (
        build_kkt_schur_batched, build_kkt_schur_batched_plain, compute_dz_batched,
        compute_dz_batched_plain, line_search_merits_batched,
        line_search_merits_batched_plain, pcg_solve_batched,
        pcg_solve_batched_plain, sqp_solve_batched_fused,
        sqp_solve_batched_fused_sharded)
    from mpcgpu_tpu_torch.parallel.mesh import make_mesh
    from mpcgpu_tpu_torch.ops.pcg_cuda import (compute_dz_cuda, compute_dz_plain,
                                               compute_dz_slab,
                                               compute_dz_slab_plain,
                                               dz_plan, k2_cluster_occupancy,
                                               k2_cluster_plan, pcg_dz_solve,
                                               pcg_dz_solve_plain,
                                               pcg_solve_cuda, pcg_solve_cuda_uncast)
    from mpcgpu_tpu_torch.ops.pcg_ca import ca_basis, ca_coeff_step
    from mpcgpu_tpu_torch.ops.pcg_ca_cuda import (ca_basis_cuda, ca_cluster_plan,
                                                  ca_coeff_step_cuda, coeff_plan)
    from mpcgpu_tpu_torch.ops.pcg_slab import pcg_slab_step, slab_state
    from mpcgpu_tpu_torch.ops.pcg_slab_cuda import (pcg_slab_step_cuda,
                                                    slab_cluster_plan)
    from mpcgpu_tpu_torch.parallel import (KnotMesh, pcg_solve_sharded,
                                           sqp_solve_sharded)
    from mpcgpu_tpu_torch.parallel.pcg_sharded import btd_matvec_halo
    from mpcgpu_tpu_torch.sim.mpc import (run_chain, simulate_mpc,
                                          simulate_mpc_ondevice,
                                          simulate_mpc_ondevice_batched)
    from mpcgpu_tpu_torch.sim.plant_cuda import (simulate_plant,
                                                 simulate_plant_batched,
                                                 simulate_plant_batched_plain,
                                                 simulate_plant_plain)
    from mpcgpu_tpu_torch.solver.kkt import build_kkt
    from mpcgpu_tpu_torch.solver.sqp import sqp_solve
    from mpcgpu_tpu_torch.solver.kkt_cuda import (build_kkt_cuda, build_kkt_schur,
                                                  build_kkt_schur_plain,
                                                  build_kkt_schur_slab,
                                                  build_kkt_schur_slab_plain,
                                                  kkt_window_plan)
    from mpcgpu_tpu_torch.solver.merit import merit_partials
    from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merit_partials_slab,
                                                    line_search_merits_fused,
                                                    line_search_merits_plain,
                                                    merit_team_plan)
    from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

    wrappers = kernel_wrappers()

    def counted(fn, *args, **kw):
        """fn(*args, **kw) with every launch count set to 0 just before it;
        returns (result, the counts just after)."""
        for w in wrappers.values():
            w.launches = 0
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, {name: w.launches for name, w in wrappers.items()}

    t_start = time.perf_counter()

    def phase(msg: str):
        print(f"{msg}  [{time.perf_counter() - t_start:.1f} s]", flush=True)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(f"card: {card}")
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} driver {driver} "
          f"python {sys.version.split()[0]}")

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    # every source at nq = 7 and at NQ_CASES, all nvcc at once
    _kernels.load([(src, nq) for nq in (7,) + NQ_CASES for src in _kernels.SOURCES])
    phase(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for (src, nq), log in _kernels.build_log.items():
        for line in ptxas_summary(log):
            print(f"  ptxas {src} nq={nq}: {line}")
    # the plans of K7 (one launch per solve) and K10b (a cluster per shard)
    for N in PCR_SIZES:
        print(f"  K7 plan N={N}: {pcr_plan(N)}")
    for N, S in SHARD_CASES + ((N_BIG, 1),):
        print(f"  K10b plan N={N} over {S} shards: {ca_cluster_plan(N // S, CA_S)}")
        print(f"  K10a plan N={N} over {S} shards: {slab_cluster_plan(N // S)}")
        print(f"  K10b' plan N={N} over {S} shards: {coeff_plan(N // S, CA_S)}")
    for N in (N_MAIN, N_BIG) + tuple(N // S for N, S in SHARD_CASES):
        print(f"  K6 / K9b plan at {N} knots (per shard): {dz_plan(N)}")

    model = iiwa14(torch.float32, device=dev)
    mu = SQPConfig().mu
    errs = {name: 0.0 for name in KERNELS}
    failures = []

    def expect(ok: bool, msg: str):
        print(("  ok   " if ok else "  FAIL ") + msg)
        if not ok:
            failures.append(msg)

    def k2_well_conditioned(N: int):
        """K2 and K2' on a well-conditioned system (synthetic_btd, with K1's
        blocks for the dz epilogue): f32 rounding stays near 1e-7 there
        (<= 2.7e-7 kernel vs plain, every part), so both are held to 2e-6
        per part, and the exit fires before the cap by either criterion.
        The fixed-step case runs min(20, 2N) steps: at N = 2 (28 unknowns)
        f32 CG on this system turns NaN from step 17 on, in the plain
        version too (eta reaches 0, then beta = 0 / 0)."""
        cost = CostConfig.for_knots(N)
        xu, xs, ee, _ = problem(N, torch, dev)
        rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
        lam0 = torch.zeros((N, 14), dtype=torch.float32, device=dev)
        u = xu[:, 14:]
        k2 = lambda s_, **kw: (pcg_dz_solve(s_, lam0, u, rho, cost.r_cost, **kw),
                               pcg_dz_solve_plain(s_, lam0, u, rho, cost.r_cost, **kw))
        syn = dict(build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0))
        syn["S"], syn["Pinv"], syn["gamma"] = synthetic_btd(N, torch, dev)
        for crit, tol, cap in (("eta", 0.0, min(20, 2 * N)), ("eta", 1e-9, 167),
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

    # ---- phase 2: kernels against their plain versions --------------------
    phase("phase 2: kernels vs plain versions on the card")
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

        # K2 and K2' on a well-conditioned system (k2_well_conditioned)
        k2_well_conditioned(N)

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
        same = torch.equal(d6, dz_kernel_ref(torch, sys_, got[0], u, rho, cost.r_cost))
        expect(same, f"K6 N={N}: bitwise equal to the earlier dz_kernel {same}")

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
    # K2 / K2' at ragged N (N not a multiple of the knots per CTA; at N = 100
    # the last CTA holds no knot), held as at N_MAIN and N_BIG; the cluster
    # plan of every size and how many such clusters the card holds at once
    for N in sorted({*K2_RAGGED, N_MAIN, N_BIG}):
        plan = k2_cluster_plan(N)
        print(f"  K2 plan N={N}: cluster {plan.cluster} CTAs x "
              f"{plan.knots_per_cta} knots, {plan.smem_bytes} B shared memory "
              f"per CTA; cudaOccupancyMaxActiveClusters K2 "
              f"{k2_cluster_occupancy(N, dz=True)}, K2' "
              f"{k2_cluster_occupancy(N, dz=False)}")
    for N in K2_RAGGED:
        k2_well_conditioned(N)
    # K1 and K3 at ragged N (the last window of K1, the last round of K3's
    # samples partly filled), held to their plain versions as at N_MAIN and
    # N_BIG; the window and team plans of every size
    for N in sorted({*KKT_RAGGED, N_MAIN, N_BIG}):
        wp, tp = kkt_window_plan(N), merit_team_plan(N, (SQPConfig().num_alphas + 1) * N)
        print(f"  K1 plan N={N}: {wp.ctas} windows of {wp.window} knots, "
              f"{wp.window + 3} knot groups of 3 warps and {wp.smem_bytes} B "
              f"shared memory per "
              f"CTA; K3 plan: teams of {tp.team} lanes, {tp.samples} samples "
              f"a block, {tp.smem_bytes} B")
    rng3 = np.random.default_rng(3)
    for N in KKT_RAGGED:
        cost = CostConfig.for_knots(N)
        xu, xs, ee, _ = problem(N, torch, dev)
        rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
        for integ in (0, 1):
            got = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, integ)
            ref = build_kkt_schur_plain(model, cost, xu, xs, ee, rho, DT, integ)
            torch.cuda.synchronize()
            worst = max(rel_err(got[key], ref[key])[1] for key in got)
            expect(worst <= 5e-5, f"K1 N={N} integrator={integ}: worst output "
                   f"{worst:.3e} max|ref| (<= 5e-5)")
        dz = torch.tensor(0.05 * rng3.standard_normal((N, 21)), dtype=torch.float32,
                          device=dev)
        m_got, a_got = line_search_merits_fused(model, cost, xu, dz, xs, ee, mu, DT)
        m_ref, a_ref = line_search_merits_plain(model, cost, xu, dz, xs, ee, mu, DT)
        torch.cuda.synchronize()
        rel = float(((m_got.double() - m_ref.double()).abs()
                     / m_ref.double().abs()).max())
        expect(rel <= 1e-4 and torch.equal(a_got, a_ref),
               f"K3 N={N}: merits max relative error {rel:.3e} (<= 1e-4), "
               f"alphas equal {torch.equal(a_got, a_ref)}")
    if failures:
        raise SmokeFailure(f"phase 2: {len(failures)} check(s) failed")

    # ---- phase 2a: K1-K4 at the chains' joint counts ----------------------
    phase(f"phase 2a: K1-K4 and K4b at nq = {NQ_CASES} vs plain versions, "
          f"N = {NQ_SIZES}")
    ctx = SimpleNamespace(torch=torch, dev=dev, expect=expect, counted=counted)
    for nq in NQ_CASES:
        wp = kkt_window_plan(N_MAIN, nq=nq)
        print(f"  nq={nq} N={N_MAIN}: K1 {wp.ctas} windows of {wp.window} knots, "
              f"{wp.smem_bytes} B; K2 {tuple(k2_cluster_plan(N_MAIN, 2 * nq))}, "
              f"{k2_cluster_occupancy(N_MAIN, nx=2 * nq)} clusters resident; K3 "
              f"{tuple(merit_team_plan(N_MAIN, 9 * N_MAIN, nq))}")
    errs_nq = nq_kernel_checks(ctx)
    if failures:
        raise SmokeFailure(f"phase 2a: {len(failures)} check(s) failed")

    # ---- phase 2b: K7 and the instance-grid kernels ----------------------
    phase("phase 2b: K7 (PCR) and K8a-c, K3b (instance grid) vs plain versions")
    # K7 on the well-conditioned system, down to N = 2 and 3, where the
    # levels without pivoting reach the whole system: within 1e-5 max|x| of
    # the plain version on the card and of the f64 solve
    for N in PCR_SIZES:
        S, _, b = synthetic_btd(N, torch, dev)
        got = pcr_solve_cuda(S, b)
        ref = pcr_solve_refined(S, b)
        f64 = pcr_solve_refined(S.double(), b.double())
        torch.cuda.synchronize()
        d, r = rel_err(got, ref)
        r64 = rel_err(got, f64)[1]
        if N == N_MAIN:
            errs["K7 pcr_solve_cuda"] = d
        expect(r <= 1e-5 and r64 <= 1e-5,
               f"K7 N={N} well-conditioned ({pcr_plan(N)}): vs plain {r:.3e}, vs "
               f"f64 {r64:.3e} max|x| (<= 1e-5)")
    # K7 on the real Schur system over REAL_SEEDS noise seeds, beside the
    # capped PCG (K2', the chain's settings) and the f64 solve (the block
    # LDL^T of the same f32 system in f64).  On the calm rows from CALM_ROW
    # at N_MAIN, the criterion of tests/test_pcr.py: K7's true residual
    # max|Sx - b| below the capped PCG's in every seed; and K7 within 1e-3
    # max|x| of the f64 solve in every seed (the plain version on the CPU:
    # median 3.1e-5), its median distance within 2x the plain version's on
    # the card.  From row 0 (N_MAIN, N_BIG) the systems have cond ~1e13 and
    # f32 PCR keeps no digits, in the JAX package too
    # (tests/test_torch_pcr_f32.py): there the kernel is held to the plain
    # version by medians (distance and residual within 2x), every solve
    # finite, and the residuals are printed.
    for N, start in ((N_MAIN, CALM_ROW), (N_MAIN, 0), (N_BIG, 0)):
        cost = CostConfig.for_knots(N)
        rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
        cap = PCGConfig.tuned_max_iter(N)
        stats = {w: {"dist": [], "res": []} for w in ("kernel", "plain", "pcg")}
        all_finite = True
        for seed in range(REAL_SEEDS):
            xu_s, xs_s, ee_s, _ = problem(N, torch, dev, seed, start)
            sys_ = build_kkt_schur(model, cost, xu_s, xs_s, ee_s, rho, DT, 0)
            S, g = sys_["S"], sys_["gamma"]
            x64 = btd_ldl_solve(S.double(), g.double())
            pcg = pcg_solve_cuda(S, sys_["Pinv"], g, torch.zeros_like(g),
                                 max_iter=cap, exit_tol=1e-5).lam
            for w, x in (("kernel", pcr_solve_cuda(S, g)),
                         ("plain", pcr_solve_refined(S, g)), ("pcg", pcg)):
                all_finite = all_finite and bool(torch.isfinite(x).all())
                stats[w]["dist"].append(rel_err(x, x64)[1])
                stats[w]["res"].append(float(
                    (btd_matvec(S.double(), x.double()) - g.double()).abs().max()))
        med = {w: {k: statistics.median(v) for k, v in d.items()}
               for w, d in stats.items()}
        below = sum(a < b for a, b in zip(stats["kernel"]["res"], stats["pcg"]["res"]))
        ok = all_finite and med["kernel"]["dist"] <= 2 * med["plain"]["dist"]
        if start == CALM_ROW:
            ok = ok and below == REAL_SEEDS and max(stats["kernel"]["dist"]) <= 1e-3
            rule = ("K7 residual below PCG's in every seed, K7 within 1e-3 of f64 "
                    "in every seed, median distance <= 2x plain")
        else:
            ok = ok and med["kernel"]["res"] <= 2 * med["plain"]["res"]
            rule = "kernel <= 2x plain in median distance and residual"
        expect(ok, f"K7 N={N} real system, rows {start}.., {REAL_SEEDS} seeds, "
               f"medians: distance to f64 kernel {med['kernel']['dist']:.3e} (max "
               f"{max(stats['kernel']['dist']):.3e}), plain card "
               f"{med['plain']['dist']:.3e} max|x|; true residual kernel "
               f"{med['kernel']['res']:.3e}, plain card {med['plain']['res']:.3e}; "
               f"capped PCG ({cap}, 1e-5) residual {med['pcg']['res']:.3e}, "
               f"distance {med['pcg']['dist']:.3e}; K7 residual below PCG's in "
               f"{below}/{REAL_SEEDS} seeds ({rule}; all finite)")

    # K8a-c and the batched K3 at B_MAIN instances of N_MAIN knots: each
    # instance equal bit for bit to the single-instance kernel (the same
    # body with an instance offset), and the first B_PLAIN instances against
    # the plain versions with the single kernels' bounds
    N, B = N_MAIN, B_MAIN
    cost = CostConfig.for_knots(N)
    xu_b, xs_b, ee_b, rho_b = batch_problem(B, N, torch, dev)
    lam0_b = torch.zeros((B, N, 14), dtype=torch.float32, device=dev)
    pcg_b = dict(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)
    sys_b = build_kkt_schur_batched(model, cost, xu_b, xs_b, ee_b, rho_b, DT)
    lam_b, it_b, cv_b = pcg_solve_batched(sys_b["S"], sys_b["Pinv"], sys_b["gamma"],
                                          lam0_b, **pcg_b)
    dz_b = compute_dz_batched(sys_b, lam_b, xu_b[:, :, 14:], rho_b, cost.r_cost)
    m_b, a_b = line_search_merits_batched(model, cost, xu_b, dz_b, xs_b, ee_b, mu, DT)
    torch.cuda.synchronize()
    differ = {"K8a": 0, "K8b": 0, "K8c": 0, "K8c vs dz_kernel": 0, "K3b": 0}
    for i in range(B):
        one = build_kkt_schur(model, cost, xu_b[i], xs_b[i], ee_b[i], rho_b[i], DT, 0)
        differ["K8a"] += not all(torch.equal(one[k], sys_b[k][i]) for k in one)
        one_i = {k: v[i] for k, v in sys_b.items()}
        p1 = pcg_solve_cuda(one_i["S"], one_i["Pinv"], one_i["gamma"], lam0_b[i],
                            **pcg_b)
        differ["K8b"] += not (torch.equal(p1.lam, lam_b[i])
                              and torch.equal(p1.iters, it_b[i])
                              and torch.equal(p1.converged, cv_b[i]))
        d1 = compute_dz_cuda(one_i, lam_b[i], xu_b[i, :, 14:], rho_b[i], cost.r_cost)
        differ["K8c"] += not torch.equal(d1, dz_b[i])
        differ["K8c vs dz_kernel"] += not torch.equal(dz_kernel_ref(
            torch, one_i, lam_b[i], xu_b[i, :, 14:], rho_b[i], cost.r_cost), dz_b[i])
        m1, a1 = line_search_merits_fused(model, cost, xu_b[i], dz_b[i], xs_b[i],
                                          ee_b[i], mu, DT)
        differ["K3b"] += not (torch.equal(m1, m_b[i]) and torch.equal(a1, a_b[i]))
    expect(all(v == 0 for v in differ.values()),
           f"K8a/K8b/K8c/K3b B={B} N={N}: instances that differ from the single "
           f"kernels (K1/K2'/K6/K3; K8c also from dz_kernel at batch = 1, the "
           f"earlier K6) bit for bit: {differ}; PCG iterations "
           f"{int(it_b.min())}..{int(it_b.max())}")
    P = B_PLAIN
    ref_b = build_kkt_schur_batched_plain(model, cost, xu_b[:P], xs_b[:P], ee_b[:P],
                                          rho_b[:P], DT)
    worst = 0.0
    for key in ref_b:
        for i in range(P):
            d, r = rel_err(sys_b[key][i], ref_b[key][i])
            errs["K8a build_kkt_schur_batched"] = max(
                errs["K8a build_kkt_schur_batched"], d)
            worst = max(worst, r)
    expect(worst <= 5e-5, f"K8a B={P}: vs plain per instance and output, worst "
           f"{worst:.3e} max|ref| (<= 5e-5)")
    # K8b on well-conditioned systems (as K2 is held): lam within 2e-6, the
    # fixed-step counts equal, the early exits within 2 iterations
    syn = [synthetic_btd(N, torch, dev, seed=1 + i) for i in range(P)]
    Sy, Py, gy = (torch.stack([t[j] for t in syn]) for j in range(3))
    for tol, cap in ((0.0, 20), (1e-9, 167)):
        got = pcg_solve_batched(Sy, Py, gy, lam0_b[:P], max_iter=cap, exit_tol=tol)
        ref = pcg_solve_batched_plain(Sy, Py, gy, lam0_b[:P], max_iter=cap,
                                      exit_tol=tol)
        torch.cuda.synchronize()
        e = max(rel_err(got[0][i], ref[0][i])[1] for i in range(P))
        errs["K8b pcg_solve_batched"] = max(errs["K8b pcg_solve_batched"],
                                            rel_err(got[0], ref[0])[0])
        ik, ip = got[1].tolist(), ref[1].tolist()
        ok = ik == ip if tol == 0.0 else (
            all(abs(a - b) <= 2 for a, b in zip(ik, ip)) and bool(got[2].all()))
        expect(ok and e <= 2e-6, f"K8b B={P} well-conditioned exit_tol={tol:g} "
               f"cap={cap}: lam vs plain {e:.3e} (<= 2e-6); iterations kernel "
               f"{ik}, plain {ip}")
    d8 = compute_dz_batched_plain({k: v[:P] for k, v in sys_b.items()}, lam_b[:P],
                                  xu_b[:P, :, 14:], rho_b[:P], cost.r_cost)
    m8, a8 = line_search_merits_batched_plain(model, cost, xu_b[:P], dz_b[:P],
                                              xs_b[:P], ee_b[:P], mu, DT)
    torch.cuda.synchronize()
    d, r = rel_err(dz_b[:P], d8)
    errs["K8c compute_dz_batched"] = d
    rel = float(((m_b[:P].double() - m8.double()).abs() / m8.double().abs()).max())
    errs["K3b line_search_merits_batched"] = float(
        (m_b[:P].double() - m8.double()).abs().max())
    expect(r <= 1e-5 and rel <= 1e-4 and torch.equal(a_b[:P], a8),
           f"K8c / K3b B={P}: dz vs plain {r:.3e} max|ref| (<= 1e-5); merits max "
           f"relative error {rel:.3e} (<= 1e-4), alphas equal "
           f"{torch.equal(a_b[:P], a8)}")
    if failures:
        raise SmokeFailure(f"phase 2b: {len(failures)} check(s) failed")

    # ---- phase 2c: the knot-sharded path's slab kernels --------------------
    phase("phase 2c: K9a-c, K10a, K10b (knot shards) vs plain versions on the card")

    def windows(N: int, S: int, lo: int, hi: int):
        """(S, L - lo + hi) knot indices of each shard's window: its L knots
        from row lo to row L - 1 + hi, wrapped around the ring."""
        L = N // S
        return torch.tensor((np.arange(S)[:, None] * L + np.arange(lo, L + hi)) % N,
                            device=dev)

    tol0 = _kernels.scalar(0.0, dev)
    slab_pcg = functools.partial(slab_pcg_run, ctx)
    ca_setup = functools.partial(ca_setup_run, ctx)
    ca_pcg = functools.partial(ca_pcg_run, ctx)
    f64s = f64_state

    def ca_kernel_checks(mesh, N, S, label, sys3, record):
        """ca_step_checks; ``record``: the kernels' max|d| against the plain
        versions go to the kernels line."""
        db, dc = ca_step_checks(ctx, mesh, N, S, label, sys3)
        if record:
            errs["K10b ca_basis_cuda"], errs["K10b' ca_coeff_step_cuda"] = db, dc

    def k10a_checks(mesh, N, S, cost, rho, syn, record):
        """K10a: the sharded PCG loop with K10a against the same loop with
        its plain step, and against K2', on the well-conditioned system
        (f32 rounding ~1e-7 there): lam within 2e-6, the same iterations.
        On the real system f32 rounding decides the last digits (phase 2):
        20 fixed steps over REAL_SEEDS noise seeds, each held to an f64
        run; the median distance of the K10a solve within 2x that of the
        same loop with the plain step (K2', classic CG, rounds otherwise:
        printed beside them).  ``record``: K10a's max|d| against the plain
        step goes to the kernels line."""
        dp = k10a_synthetic_checks(ctx, mesh, N, S, syn)
        if record:
            errs["K10a pcg_slab_step_cuda"] = dp
        dist = {"K10a": [], "plain step": [], "K2'": []}
        for seed in range(REAL_SEEDS):
            xu_s, xs_s, ee_s, _ = problem(N, torch, dev, seed)
            sy = build_kkt_schur(model, cost, xu_s, xs_s, ee_s, rho, DT, 0)
            SS, PP, gg = sy["S"], sy["Pinv"], sy["gamma"]
            f64 = pcg_solve(SS.double(), PP.double(), gg.double(),
                            torch.zeros_like(gg.double()), max_iter=20,
                            exit_tol=0.0).lam
            for name, lam_ in (
                    ("K10a", slab_pcg(mesh, SS, PP, gg, pcg_slab_step_cuda, 20, 0.0)[0]),
                    ("plain step", slab_pcg(mesh, SS, PP, gg, pcg_slab_step, 20, 0.0)[0]),
                    ("K2'", pcg_solve_cuda(SS, PP, gg, torch.zeros_like(gg),
                                           max_iter=20, exit_tol=0.0).lam)):
                dist[name].append(rel_err(lam_, f64)[1])
        med = {k: statistics.median(v) for k, v in dist.items()}
        expect(med["K10a"] <= 2 * med["plain step"],
               f"K10a N={N} over {S} shards, real system, 20 fixed steps, "
               f"{REAL_SEEDS} seeds: median distance to f64 "
               + ", ".join(f"{k} {v:.3e}" for k, v in med.items())
               + " (K10a <= 2x the plain step)")

    def exited_checks(mesh, N, S, sys3):
        """One call of K10a and one of the coefficient step in which the
        even shards have exited (K10a: the summed eta 0 below exit_tol;
        K10b': done) and the odd ones work: every exited shard's state bit
        for bit what it was (the entry test and the cluster's exit race),
        every working shard's bit for bit what the same kernel gives it in
        a call where no shard has exited (the shards share nothing inside
        a call)."""
        SS, PP, gg = (t.reshape(S, N // S, *t.shape[1:]) for t in sys3)
        PL, PR = mesh.send_right(PP[:, -1]), mesh.send_left(PP[:, 0])
        lam0 = torch.zeros_like(gg)
        st = slab_state(lam0, gg - btd_matvec_halo(SS, lam0, mesh))
        pk = lambda: (mesh.send_right(st["pkt"][:, 0]), mesh.send_left(st["pkt"][:, 1]))
        pcg_slab_step(st, SS, PP, *pk(), PL, PR, st["dots"], CA_CAP, tol0, "eta", True)
        tot = mesh.psum(st["dots"])
        mixed = tot.clone()
        mixed[0::2, 0] = 0.0
        tol = _kernels.scalar(1e-30, dev)
        got, ref = clone_state(st), clone_state(st)
        pcg_slab_step_cuda(got, SS, PP, *pk(), PL, PR, mixed, CA_CAP, tol, "eta")
        pcg_slab_step_cuda(ref, SS, PP, *pk(), PL, PR, tot, CA_CAP, tol, "eta")
        torch.cuda.synchronize()
        kept = all(torch.equal(got[k][0::2], st[k][0::2]) for k in st)
        worked = all(torch.equal(got[k][1::2], ref[k][1::2]) for k in st)
        stepped = got["iters"][1::2].tolist() == [1] * (S // 2)
        expect(kept and worked and stepped,
               f"K10a N={N} over {S} shards, shards 0, 2, .. exited: their state "
               f"bit for bit unchanged {kept}; the working shards' bit for bit "
               f"as with none exited {worked}, stepped {stepped}")
        cst, _ = ca_setup(mesh, *sys3)
        ctot = mesh.psum(cst["parts"])
        got, ref = clone_state(cst), clone_state(cst)
        got["done"][0::2] = 1
        before = clone_state(got)
        ca_coeff_step_cuda(got, ctot, CA_CAP, tol0, "eta", CA_S)
        ca_coeff_step_cuda(ref, ctot, CA_CAP, tol0, "eta", CA_S)
        torch.cuda.synchronize()
        kept = all(torch.equal(got[k][0::2], before[k][0::2]) for k in got)
        worked = all(torch.equal(got[k][1::2], ref[k][1::2]) for k in cst)
        expect(kept and worked,
               f"K10b' (coefficient step) N={N} over {S} shards, shards 0, 2, .. "
               f"done: their state bit for bit unchanged {kept}; the working "
               f"shards' bit for bit as with none done {worked}")

    slab_ref = {}     # per case: the inputs phase 5 times the kernels on
    for N, S in SHARD_CASES:
        L = N // S
        main_case = (N, S) == SHARD_CASES[0]
        cost = CostConfig.for_knots(N)
        xu, xs, ee, _ = problem(N, torch, dev)
        rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
        w = windows(N, S, -2, 2)
        first, last = (w == 0).float(), (w == N - 1).float()
        xe, ee_x = xu[w].contiguous(), ee[w].contiguous()
        # K9a against its plain version per output, and its interior rows
        # against K1 bit for bit (the same device code on the same rows);
        # the second case takes the semi-implicit integrator and the
        # reference's x_{N-2} terminal cost (the runtime last flag)
        for integ, c9 in ((0, cost), (1, dataclasses.replace(
                cost, terminal_at_last_state=False))):
            got = build_kkt_schur_slab(model, c9, xe, ee_x, first, last, rho, DT, integ)
            ref = build_kkt_schur_slab_plain(model, c9, xe, ee_x, first, last, rho,
                                             DT, integ)
            k1 = build_kkt_schur(model, c9, xu, xs, ee, rho, DT, integ)
            torch.cuda.synchronize()
            worst, same = 0.0, True
            for key in got:
                d, r = rel_err(got[key], ref[key])
                worst = max(worst, r)
                if main_case:
                    errs["K9a build_kkt_schur_slab"] = max(
                        errs["K9a build_kkt_schur_slab"], d)
                same = same and torch.equal(
                    got[key][:, 2:2 + L].reshape(k1[key].shape), k1[key])
            expect(worst <= 5e-5 and same,
                   f"K9a N={N} over {S} shards, integrator={integ}, terminal at "
                   f"x_N-1 {c9.terminal_at_last_state}: vs plain per output, worst "
                   f"{worst:.3e} max|ref| (<= 5e-5); interior rows == K1 bit for "
                   f"bit {same}")
        k1 = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0)
        sl = {k: v[:, 2:2 + L] for k, v in build_kkt_schur_slab(
            model, cost, xe, ee_x, first, last, rho, DT).items()}
        # K9b on K9a's interior blocks and a 20-step PCG lam: against its
        # plain version, and K6 on K1's blocks bit for bit
        lam = pcg_solve_cuda(k1["S"], k1["Pinv"], k1["gamma"],
                             torch.zeros_like(k1["gamma"]), max_iter=20,
                             exit_tol=0.0).lam
        lam_s = lam.reshape(S, L, 14)
        lam_n = torch.roll(lam, -1, 0).reshape(S, L, 14)
        last_s = (torch.arange(N, device=dev) == N - 1).float().reshape(S, L)
        u_s = xu.reshape(S, L, 21)[..., 14:]
        d9 = compute_dz_slab(sl, lam_s, lam_n, last_s, u_s, rho, cost.r_cost)
        p9 = compute_dz_slab_plain(sl, lam_s, lam_n, last_s, u_s, rho, cost.r_cost)
        d6 = compute_dz_cuda(k1, lam, xu[:, 14:], rho, cost.r_cost)
        torch.cuda.synchronize()
        d, r = rel_err(d9, p9)
        if main_case:
            errs["K9b compute_dz_slab"] = d
        same = torch.equal(d9.reshape(N, 21), d6)
        expect(r <= 1e-5 and same, f"K9b N={N} over {S} shards: vs plain "
               f"{r:.3e} max|ref| (<= 1e-5); == K6 bit for bit {same}")
        same = torch.equal(d9, dz_slab_kernel_ref(torch, sl, lam_s, lam_n, last_s, u_s,
                                                  rho, cost.r_cost))
        expect(same, f"K9b N={N} over {S} shards: bitwise equal to the earlier "
               f"dz_kernel {same}")
        # K9c on each shard's L knots and the next shard's first: per-knot
        # terms against its plain version, and, corrected at the global ends
        # and summed, against K3's merits (both 1e-4 relative, K3's bound)
        w1 = windows(N, S, 0, 1)
        x1, z1, e1 = xu[w1].contiguous(), d6[w1].contiguous(), ee[w1].contiguous()
        kc, kd, ka = line_search_merit_partials_slab(model, cost, x1, z1, e1, DT)
        pc, pd, pa = merit_partials(model, cost, x1, z1, e1, DT)
        m3 = line_search_merits_fused(model, cost, xu, d6, xs, ee, mu, DT)[0]
        torch.cuda.synchronize()
        (dc, rc), rd = rel_err(kc, pc), rel_err(kd, pd)[1]
        if main_case:
            errs["K9c line_search_merit_partials_slab"] = dc
        kc, kd = kc[..., :L], kd[..., :L]
        u_last = xu[-1, 14:] + ka[:, None] * d6[-1, 14:]
        x0 = (xu[0, :14] + ka[:, None] * d6[0, :14] - xs).abs().sum(-1)
        m9 = (kc.sum((0, 2)) - 0.5 * cost.r_cost * (u_last * u_last).sum(-1)) \
            + mu * ((kd.sum((0, 2)) - kd[-1, :, -1]) + x0)
        r3 = float(((m9.double() - m3.double()).abs() / m3.double().abs()).max())
        expect(rc <= 1e-4 and rd <= 1e-4 and torch.equal(ka, pa) and r3 <= 1e-4,
               f"K9c N={N} over {S} shards: per-knot cost {rc:.3e}, defect "
               f"{rd:.3e} max|ref| vs plain (<= 1e-4), alphas equal "
               f"{torch.equal(ka, pa)}; assembled merits vs K3 {r3:.3e} (<= 1e-4)")
        slab_ref[N] = dict(xe=xe, ee=ee_x, first=first, last=last, sl=sl,
                           lam_s=lam_s, lam_n=lam_n, last_s=last_s, u_s=u_s,
                           x1=x1, z1=z1, e1=e1, cost=cost, rho=rho, k1=k1)

        mesh = KnotMesh(S)
        syn = synthetic_btd(N, torch, dev)
        k10a_checks(mesh, N, S, cost, rho, syn, main_case)
        if main_case:
            exited_checks(mesh, N, S, (k1["S"], k1["Pinv"], k1["gamma"]))

        # K9a's blocks at the horizon's ends: the s-step and pipelined forms
        # rely on these corner blocks to cancel the ring-wrap rows
        corners = torch.stack([sl["S"][0, 0, 0], sl["Pinv"][0, 0, 0],
                               sl["S"][-1, -1, 2], sl["Pinv"][-1, -1, 2]])
        nz = int(torch.count_nonzero(corners))
        expect(nz == 0, f"K9a N={N} over {S} shards: corner blocks S[0,0], "
               f"Pinv[0,0], S[N-1,2], Pinv[N-1,2] exactly 0 ({nz} nonzero entries)")
        for label, sys3 in (("well-conditioned", syn),
                            ("real", (k1["S"], k1["Pinv"], k1["gamma"]))):
            ca_kernel_checks(mesh, N, S, label, sys3, main_case and label == "real")
        ca_pcg_synthetic_checks(ctx, mesh, N, S, syn)
        dist = {"K10b": [], "plain steps": [], "K10a": [], "K2'": []}
        for seed in range(REAL_SEEDS):
            xu_s, xs_s, ee_s, _ = problem(N, torch, dev, seed)
            sy = build_kkt_schur(model, cost, xu_s, xs_s, ee_s, rho, DT, 0)
            SS, PP, gg = sy["S"], sy["Pinv"], sy["gamma"]
            f64 = pcg_solve(SS.double(), PP.double(), gg.double(),
                            torch.zeros_like(gg.double()), max_iter=20,
                            exit_tol=0.0).lam
            for name, lam_ in (
                    ("K10b", ca_pcg(mesh, SS, PP, gg, True, 20, 0.0)[0]),
                    ("plain steps", ca_pcg(mesh, SS, PP, gg, False, 20, 0.0)[0]),
                    ("K10a", slab_pcg(mesh, SS, PP, gg, pcg_slab_step_cuda, 20, 0.0)[0]),
                    ("K2'", pcg_solve_cuda(SS, PP, gg, torch.zeros_like(gg),
                                           max_iter=20, exit_tol=0.0).lam)):
                dist[name].append(rel_err(lam_, f64)[1])
        med = {k: statistics.median(v) for k, v in dist.items()}
        expect(med["K10b"] <= 2 * med["plain steps"],
               f"s-step PCG (K10b) N={N} over {S} shards, real system, 20 fixed "
               f"steps, {REAL_SEEDS} seeds: median distance to f64 "
               + ", ".join(f"{k} {v:.3e}" for k, v in med.items())
               + " (K10b <= 2x the plain steps)")
    def one_shard_sqp(N, trace, start):
        """The fused sharded SQP at its default route on one shard of N
        knots against pcg_cuda (phase 4d's criteria, the comment below)."""
        cost = CostConfig.for_knots(N)
        xu, xs, ee, _ = problem(N, torch, dev, 0, start, trace)
        sh_kw = (cost, SQPConfig(max_iter=2, max_time_us=None),
                 PCGConfig(max_iter=PCGConfig.tuned_max_iter(N_BIG), exit_tol=1e-5))
        lam0 = torch.zeros((N, 14), dtype=torch.float32, device=dev)
        ca1, n_ca1 = counted(sqp_solve_sharded, model, *sh_kw, xu, lam0, xs, ee, RHO0,
                             DT, KnotMesh(1))
        one = sqp_solve(model, *sh_kw, xu, lam0, xs, ee, RHO0, DT, linsys="pcg_cuda")
        plain = sqp_solve(model, *sh_kw, xu, lam0, xs, ee, RHO0, DT, linsys="pcg",
                          merit_impl="plain")
        f64 = sqp_solve(iiwa14(torch.float64, device=dev), *sh_kw, xu.double(),
                        lam0.double(), xs.double(), ee.double(), RHO0, DT,
                        linsys="pcg", merit_impl="plain")
        torch.cuda.synchronize()
        it1, outer = int(ca1.sqp_iters), -(-sh_kw[2].max_iter // CA_S)
        want = {k: it1 for k in KERNELS if k.startswith("K9")}
        want.update({"K10b ca_basis_cuda": it1 * outer,
                     "K10b' ca_coeff_step_cuda": it1 * outer})
        ec, eo, ep = (part_errs(r_.xu, f64.xu) for r_ in (ca1, one, plain))
        near = all(abs(a - b) <= CA_S for a, b in
                   zip(ca1.pcg_iters.tolist(), one.pcg_iters.tolist()))
        same_ls = ca1.ls_alpha_idx.tolist() == one.ls_alpha_idx.tolist()
        ok = all(n_ca1[k] == want.get(k, 0) for k in KERNELS) and near and same_ls
        ok = ok and all(bool(torch.isfinite(t).all()) for t in (ca1.xu, ca1.lam))
        ok = ok and all(ec[k] <= 2 * max(eo[k], ep[k]) + 1e-4 for k in ("x", "u"))
        expect(ok, f"sharded SQP at its default (ca_slab) N={N} over 1 shard from "
               f"{trace} row {start}: launches {n_ca1} (K9a-c once per SQP iteration, "
               f"{it1}; K10b and the coefficient step {outer} times per iteration); "
               f"to f64 x {ec['x']:.3e}, u {ec['u']:.3e} (pcg_cuda {eo['x']:.3e}, "
               f"{eo['u']:.3e}; plain {ep['x']:.3e}, {ep['u']:.3e}; <= 2x max + 1e-4); "
               f"PCG iterations {ca1.pcg_iters.tolist()} (pcg_cuda "
               f"{one.pcg_iters.tolist()}, within {CA_S}); line search "
               f"{ca1.ls_alpha_idx.tolist()} (pcg_cuda {one.ls_alpha_idx.tolist()})")

    # N_BIG on one shard (L = N_BIG, s = CA_S): the plan's largest slab, S and
    # Pinv read from L2 (ca_cluster_plan), from phase 4d's calm start: K10b
    # and the coefficient step against their plain versions as above, and
    # the sharded s-step PCG through them against K2' on the well-conditioned
    # system (as above), and K10a as at the shard cases.  The fused sharded
    # SQP at its default route ("auto" -> "ca_slab") runs on one shard at
    # N_BIG - 4 and at N_BIG (K9a's slab holds the shard's knots and 4 halo
    # knots: 516 at N_BIG, K9A_MAX_KNOTS), on trace 3_4 from row 0,
    # against pcg_cuda as phase 4d holds it: K10b and the coefficient step
    # launched per outer step, the PCG counts within s of pcg_cuda's, the
    # same line-search choices, the distance to the f64 solve per part
    # within 2x the larger of pcg_cuda's and the plain f32 solve's + 1e-4
    N, S = N_BIG, 1
    trace, start = SHARD_START[N]
    cost = CostConfig.for_knots(N)
    xu, xs, ee, _ = problem(N, torch, dev, 0, start, trace)
    rho = torch.tensor(RHO0, dtype=torch.float32, device=dev)
    k1 = build_kkt_schur(model, cost, xu, xs, ee, rho, DT, 0)
    ca_kernel_checks(KnotMesh(S), N, S, f"{trace} row {start}",
                     (k1["S"], k1["Pinv"], k1["gamma"]), False)
    syn = synthetic_btd(N, torch, dev)
    k10a_checks(KnotMesh(S), N, S, cost, rho, syn, False)
    a = ca_pcg(KnotMesh(S), *syn, True, 167, 1e-9)
    k2p = pcg_solve_cuda(*syn, torch.zeros_like(syn[2]), max_iter=167, exit_tol=1e-9)
    torch.cuda.synchronize()
    e2 = rel_err(a[0], k2p.lam)[1]
    expect(e2 <= 2e-6 and abs(a[1] - int(k2p.iters)) <= CA_S and a[2]
           and bool(k2p.converged),
           f"s-step PCG (K10b) N={N} over {S} shard, well-conditioned eta "
           f"exit_tol=1e-09 cap=167: vs K2' {e2:.3e} (<= 2e-6); iterations K10b "
           f"{a[1]}, K2' {int(k2p.iters)} (within {CA_S}); converged {a[2]}")
    for N in (N_BIG - 4, N_BIG):
        one_shard_sqp(N, trace, start)
    if failures:
        raise SmokeFailure(f"phase 2c: {len(failures)} check(s) failed")

    # ---- phase 2d: every kernel beside K1-K4 at the chains' joint counts --
    phase(f"phase 2d: K5, K2', K6, K7, K8a-c, K3b, K9a-c, K10a, K10b, K10b' at "
          f"nq = {NQ_CASES} vs plain versions")
    for nq in NQ_CASES:
        nx = 2 * nq
        print(f"  nq={nq}: K7 {pcr_plan(N_MAIN, nx)}; " + "; ".join(
            f"N={N} over {S}: K10a {tuple(slab_cluster_plan(N // S, nx=nx))}, K10b "
            f"{tuple(ca_cluster_plan(N // S, CA_S, nx=nx))}, K10b' "
            f"{tuple(coeff_plan(N // S, CA_S, nx=nx))}" for N, S in NQ_SHARDS[nq]))
    errs_slice = slice_kernel_checks(ctx)
    if failures:
        raise SmokeFailure(f"phase 2d: {len(failures)} check(s) failed")

    # ---- phase 2e: K6 and K9b right behind the kernels that write their inputs
    phase(f"phase 2e: race check, K1 -> K6 and K9a -> K9b, {RACE_CALLS} pairs in a "
          f"graph, at nq = {tuple(RACE_CASES)}")
    dz_race_checks(ctx)
    if failures:
        raise SmokeFailure(f"phase 2e: {len(failures)} check(s) failed")

    # ---- phase 3: the main path -------------------------------------------
    phase(f"phase 3: the chain, {CHAIN_STEPS} warm-started steps, N={N_MAIN}")
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
    phase(f"phase 4: closed loop, N={N_MAIN}, trace 0_0[:{LOOP_ROWS}], "
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

    band_400, band_48 = spread_band(ens_400), spread_band(ens_48)
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
    split_route_order(ctx, model, cost, loop_kw["pcg_cfg"], xu_l0, ee_l0)
    launches = {k: n_main[k] for k in list(KERNELS)[:4]}
    launches["K5 build_kkt_cuda"] = route_n["fused=False"]["K5 build_kkt_cuda"]
    for k in ("K2' pcg_solve_cuda", "K6 compute_dz_cuda"):
        launches[k] = route_n["fused_dz=False"][k]
    if failures:
        raise SmokeFailure(f"phase 4: {len(failures)} check(s) failed")

    # ---- phase 4b: the direct solvers' closed loop -------------------------
    # the reference's PCG-vs-QDLDL comparison on the card: the host loop for
    # ROUTE_UPDATES updates through each direct linsys next to pcg_cuda, on
    # the calm rows of the trace (from row 0 the line search rejects every
    # f32 PCR step and the PCR loops keep the warm-start plan)
    phase(f"phase 4b: direct solvers, host loop, N={N_MAIN}, {ROUTE_UPDATES} "
          f"updates from row {CALM_ROW}")
    xu_calm = load_xu_traj("0_0")[CALM_ROW:CALM_ROW + LOOP_ROWS]
    ee_calm = load_eepos_traj("0_0")[CALM_ROW:CALM_ROW + LOOP_ROWS]
    direct_kw = {"pcg_cuda": {}, "pcr_cuda": {}, "pcr": dict(merit_impl="plain"),
                 "ldl": {}, "qdldl_host": {}}
    # kernels each route launches once per SQP iteration (K4 once per update)
    direct_used = {"pcg_cuda": k1_k3,
                   "pcr_cuda": ["K5 build_kkt_cuda", "K7 pcr_solve_cuda",
                                "K3 line_search_merits_fused"],
                   "pcr": [],
                   "ldl": ["K5 build_kkt_cuda", "K3 line_search_merits_fused"],
                   "qdldl_host": ["K5 build_kkt_cuda", "K3 line_search_merits_fused"]}
    direct_runs, direct_summary = {}, {}

    def host_loop(linsys, xu=None, updates=ROUTE_UPDATES, **kw):
        return simulate_mpc(model, xu_calm if xu is None else xu, ee_calm, N, DT,
                            sim_cfg=SimConfig(max_control_updates=updates),
                            linsys=linsys, **loop_kw, **kw)

    for linsys, kw in direct_kw.items():
        run, n_d = counted(host_loop, linsys, **kw)
        s_d = run.summary()
        it_d = sum(run.sqp_iters)
        err_d = np.asarray(run.tracking_errors)
        direct_runs[linsys] = (run, n_d)
        gave_up = sum(bool(g) for g in run.sqp_exits)
        direct_summary[linsys] = dict(avg_sqp_time_us=s_d["avg_sqp_time_us"],
                                      mean_tracking_error=float(err_d.mean()),
                                      sqp_iters=it_d, gave_up=gave_up)
        # the loop's warm-up solve (REMOVE_JITTERS) adds up to max_iter
        # unrecorded iterations
        warm = loop_kw["sqp_cfg"].max_iter
        ok = all(it_d <= n_d[k] <= it_d + warm if k in direct_used[linsys]
                 else n_d[k] == 0 for k in KERNELS if k != "K4 simulate_plant")
        ok = ok and n_d["K4 simulate_plant"] == ROUTE_UPDATES
        ok = ok and len(err_d) == ROUTE_SHIFTS and finite(err_d)
        if linsys != "pcg_cuda":
            ok = ok and s_d["avg_pcg_iters"] == 1.0
        expect(ok, f"direct {linsys}: avg_sqp_time_us {s_d['avg_sqp_time_us']:.1f}, "
               f"mean tracking error {err_d.mean():.6g} over {len(err_d)} shifts, "
               f"{it_d} SQP iterations, line search gave up in {gave_up} of "
               f"{ROUTE_UPDATES} solves; launches {n_d} (kernels "
               f"{direct_used[linsys]} once per SQP iteration and the warm-up's, "
               f"K4 once per update)")
    # the exact solvers track alike: pcr_cuda, pcr and qdldl_host within 1%
    # of ldl's mean tracking error (the plain pcr and ldl loops on the CPU:
    # 0.12362 and 0.123535, the plain pcg loop 0.125561; from row 0 the PCR
    # loops, rejecting every step, read 450x below ldl's)
    m_ldl = direct_summary["ldl"]["mean_tracking_error"]
    for linsys in ("pcr_cuda", "pcr", "qdldl_host"):
        m_d = direct_summary[linsys]["mean_tracking_error"]
        expect(abs(m_d / m_ldl - 1) <= 1e-2,
               f"direct {linsys} vs ldl: mean tracking error {m_d:.6g} vs "
               f"{m_ldl:.6g} (within 1%)")
    # pcr_cuda against the all-plain pcr loop: the band of LOOP_ENSEMBLE
    # pcr_cuda loops from traces moved by one f32 ulp per entry (the method
    # of phase 4), widened by its own ratio hi/lo
    ens_pcr = [direct_summary["pcr_cuda"]["mean_tracking_error"]]
    rng = np.random.default_rng(3)
    calm32 = xu_calm.astype(np.float32)
    for _ in range(LOOP_ENSEMBLE):
        way = np.where(rng.random(calm32.shape) < 0.5, -np.inf, np.inf).astype(np.float32)
        run = host_loop("pcr_cuda", xu=np.nextafter(calm32, way).astype(np.float64))
        ens_pcr.append(float(np.mean(run.tracking_errors)))
    band_pcr = spread_band(ens_pcr)
    m_pcr = direct_summary["pcr"]["mean_tracking_error"]
    expect(band_pcr[0] <= m_pcr <= band_pcr[1],
           f"direct pcr (all plain) vs pcr_cuda: mean tracking error {m_pcr:.6g}; "
           f"pcr_cuda under 1-ulp trace changes {min(ens_pcr):.6g}..{max(ens_pcr):.6g} "
           f"(band {band_pcr[0]:.6g}..{band_pcr[1]:.6g})")
    # the direct-solver tracker script, on the card by default
    rows_q, n_q = counted(track_iiwa_qdldl.main,
                          ["--knots", str(N_MAIN), "--steps", str(TRACKER_STEPS),
                           "--linsys", "pcr_cuda"])
    s_q = rows_q[0]
    expect(n_q["K7 pcr_solve_cuda"] > 0 and s_q["control_updates"] > 0
           and np.isfinite(s_q["avg_tracking_error"]),
           f"track_iiwa_qdldl --knots {N_MAIN} --steps {TRACKER_STEPS} --linsys "
           f"pcr_cuda: {s_q['control_updates']} updates, avg_sqp_time_us "
           f"{s_q['avg_sqp_time_us']:.1f}, avg_tracking_error "
           f"{s_q['avg_tracking_error']:.6g}; K7 launched {n_q['K7 pcr_solve_cuda']} times")
    launches["K7 pcr_solve_cuda"] = direct_runs["pcr_cuda"][1]["K7 pcr_solve_cuda"]

    # ---- phase 4c: the batched solve --------------------------------------
    phase(f"phase 4c: batched SQP solve, B={B_MAIN}, N={N_MAIN}, 2 SQP iterations")
    sqp_b = SQPConfig(max_iter=2)
    batched = make_batched_sqp_solver(model, cost, sqp_b, pcg_cfg, DT)
    res_b, n_b = counted(batched, xu_b, lam0_b, xs_b, ee_b, rho_b)
    loops_b = int(res_b.sqp_iters.max())
    k8 = [k for k in KERNELS if k.startswith(("K8", "K3b"))]
    expect(all(n_b[k] == loops_b for k in k8)
           and all(n_b[k] == 0 for k in KERNELS if k not in k8)
           and all(bool(torch.isfinite(t).all())
                   for t in (res_b.xu, res_b.lam, res_b.rho, res_b.merit)),
           f"batched (make_batched_sqp_solver, fused='auto'): every instance "
           f"finite; launches {n_b} (K8a-c, K3b once per SQP iteration, "
           f"{loops_b}); SQP iterations per instance "
           f"{sorted(set(res_b.sqp_iters.tolist()))}, gave up "
           f"{int(res_b.gave_up.sum())}, PCG iterations "
           f"{int(res_b.pcg_iters[:, 0].min())}..{int(res_b.pcg_iters[:, 0].max())}")
    picks = [i * (B_MAIN // BATCH_PICKS) for i in range(BATCH_PICKS)]
    differ = []
    for i in picks:
        one = sqp_solve(model, cost, sqp_b, pcg_cfg, xu_b[i], lam0_b[i], xs_b[i],
                        ee_b[i], rho_b[i], DT, linsys="pcg_cuda")
        differ += [(i, f) for f in one._fields
                   if not torch.equal(getattr(res_b, f)[i], getattr(one, f))]
    expect(not differ, f"batched vs single fused solves (K1 -> K2 -> K3) of "
           f"instances {picks}: every field bit for bit; differing {differ}")
    # the instance-sharded solve: each of FLEET_INSTANCES groups solves its
    # slab; every field of every instance bit for bit the unsharded solve's
    b_args = (model, cost, sqp_b, pcg_cfg, xu_b, lam0_b, xs_b, ee_b, rho_b, DT)
    (sh_b, n_shb), ref_b = (counted(sqp_solve_batched_fused_sharded, *b_args,
                                    make_mesh(n_instance=FLEET_INSTANCES)),
                            sqp_solve_batched_fused(*b_args))
    differ = [f for f in ref_b._fields
              if not torch.equal(getattr(sh_b, f), getattr(ref_b, f))]
    expect(not differ and n_shb[k8[0]] >= FLEET_INSTANCES * int(sh_b.sqp_iters.min()),
           f"sqp_solve_batched_fused_sharded over make_mesh(n_instance="
           f"{FLEET_INSTANCES}) vs sqp_solve_batched_fused, B={B_MAIN}: xu, lam, "
           f"rho, iteration counts and line-search choices bit for bit; differing "
           f"{differ}; launches {n_shb}")
    for k in k8:
        launches[k] = n_b[k]
    if failures:
        raise SmokeFailure(f"phase 4b/4c: {len(failures)} check(s) failed")

    # ---- phase 4d: the knot-sharded SQP and closed loop ---------------------
    phase(f"phase 4d: knot-sharded SQP and closed loop, N={SHARD_CASES[0][0]} "
          f"over {SHARD_CASES[0][1]} shards and N={SHARD_CASES[1][0]} over "
          f"{SHARD_CASES[1][1]}, from {SHARD_START}")
    k9_k10 = [k for k in KERNELS if k.startswith(("K9", "K10a"))]
    shard_summary = {}
    for N, S in SHARD_CASES:
        trace, start = SHARD_START[N]
        cost = CostConfig.for_knots(N)
        sh_kw = dict(sqp_cfg=SQPConfig(max_iter=2, max_time_us=None),
                     pcg_cfg=PCGConfig(max_iter=PCGConfig.tuned_max_iter(N),
                                       exit_tol=1e-5))
        cap = sh_kw["pcg_cfg"].max_iter
        xu, xs, ee, _ = problem(N, torch, dev, 0, start, trace)
        lam0 = torch.zeros((N, 14), dtype=torch.float32, device=dev)
        args = (cost, sh_kw["sqp_cfg"], sh_kw["pcg_cfg"])
        # one solve of 2 SQP iterations: fused="auto" takes the slab kernels,
        # pcg_method="pipelined" K10a
        sh, n_sh = counted(sqp_solve_sharded, model, *args, xu, lam0, xs, ee, RHO0,
                           DT, KnotMesh(S), pcg_method="pipelined")
        it_sh = int(sh.sqp_iters)
        one = sqp_solve(model, *args, xu, lam0, xs, ee, RHO0, DT, linsys="pcg_cuda")
        plain = sqp_solve(model, *args, xu, lam0, xs, ee, RHO0, DT, linsys="pcg",
                          merit_impl="plain")
        sh_plain = sqp_solve_sharded(model, *args, xu, lam0, xs, ee, RHO0, DT,
                                     KnotMesh(S), fused=False, pcg_method="pipelined")
        f64 = sqp_solve(m64, *args, xu.double(), lam0.double(), xs.double(),
                        ee.double(), RHO0, DT, linsys="pcg", merit_impl="plain")
        torch.cuda.synchronize()
        want = {k: it_sh for k in k9_k10}
        want["K10a pcg_slab_step_cuda"] = it_sh * (cap + 1)
        ok = all(n_sh[k] == want.get(k, 0) for k in KERNELS)
        ok = ok and all(bool(torch.isfinite(t).all()) for t in
                        (sh.xu, sh.lam, sh.rho, sh.merit))
        # the comparison below means something only if the line search takes
        # a step (from rows that run away no f32 step is taken)
        ok = ok and bool((sh.ls_alpha_idx >= 0).any())
        expect(ok, f"sharded SQP N={N} over {S} shards from {trace} row {start}: launches "
               f"{n_sh} (K9a-c once per SQP iteration, {it_sh}; K10a (cap + 1) "
               f"times per iteration; nothing else); finite; line search took "
               f"{sh.ls_alpha_idx.tolist()} (a step)")
        # the f32 solves of this system differ by rounding (phase 3), and the
        # pipelined CG rounds otherwise than the classic one (phase 2c): the
        # sharded kernels' distance to the f64 solve per part is held within
        # 2x the largest of the single-device kernels', the plain f32 solve's
        # and the plain sharded (pipelined) solve's, plus 1e-4 for the exit
        # point of a PCG stopped at 1e-5
        es, eo = part_errs(sh.xu, f64.xu), part_errs(one.xu, f64.xu)
        ep, eq = part_errs(plain.xu, f64.xu), part_errs(sh_plain.xu, f64.xu)
        for key in ("x", "u"):
            expect(es[key] <= 2 * max(eo[key], ep[key], eq[key]) + 1e-4,
                   f"sharded SQP N={N} over {S} shards, {key} part: to f64 sharded "
                   f"{es[key]:.3e}, pcg_cuda {eo[key]:.3e}, plain {ep[key]:.3e}, "
                   f"plain sharded {eq[key]:.3e} max|{key}| (<= 2x max + 1e-4); "
                   f"PCG iterations sharded "
                   f"{sh.pcg_iters.tolist()}, pcg_cuda {one.pcg_iters.tolist()}, "
                   f"f64 {f64.pcg_iters.tolist()}; line search {sh.ls_alpha_idx.tolist()}, "
                   f"{one.ls_alpha_idx.tolist()}, {f64.ls_alpha_idx.tolist()}")

        # SHARD_UPDATES on-device control updates, knot-sharded, beside the
        # single-device main path's loop on the same rows
        xu_tr = load_xu_traj(trace)[start:start + N + LOOP_ROWS]
        ee_tr = load_eepos_traj(trace)[start:start + N + LOOP_ROWS]

        def sh_loop(updates, knot_mesh=None, **kw):
            return simulate_mpc_ondevice(
                model, xu_tr, ee_tr, N, DT,
                sim_cfg=SimConfig(max_control_updates=updates),
                knot_mesh=knot_mesh, **sh_kw, **kw)

        run, n_run = counted(sh_loop, SHARD_UPDATES, knot_mesh=KnotMesh(S))
        it_run = int(run["sqp_iters"].sum())
        want = {k: it_run for k in k9_k10}
        want["K10a pcg_slab_step_cuda"] = it_run * (cap + 1)
        want["K4 simulate_plant"] = SHARD_UPDATES
        err_sh = run["tracking_errors"].double().cpu().numpy()
        ok = all(n_run[k] == want.get(k, 0) for k in KERNELS)
        ok = ok and run["control_updates"] == SHARD_UPDATES
        ok = ok and len(err_sh) == ROUTE_SHIFTS and finite(err_sh, run["xs_path"])
        single = sh_loop(SHARD_UPDATES)
        err_1 = single["tracking_errors"].double().cpu().numpy()
        m_sh, m_1 = float(err_sh.mean()), float(err_1.mean())
        # calm rows: f32 loops track alike (phase 4b's exact solvers lie
        # within 0.24% of each other there), so within 1% of the
        # single-device main path's loop
        ok = ok and abs(m_sh / m_1 - 1) <= 1e-2
        expect(ok, f"sharded loop N={N} over {S} shards from {trace} row {start}, "
               f"{SHARD_UPDATES} updates: launches {n_run} (K9a-c once per SQP "
               f"iteration, {it_run}; K10a (cap + 1) times; K4 once per update); "
               f"mean tracking error over {len(err_sh)} shifts {m_sh:.6g} (within "
               f"1% of the single-device loop's {m_1:.6g}); finite")

        # the solve's default: pcg_method "auto" -> "ca_slab", K10b and the
        # coefficient step once per outer step of s iterations on K9a's
        # blocks, ceil(cap / s) outer steps enqueued per SQP iteration
        outer = -(-cap // CA_S)
        k10b = ["K10b ca_basis_cuda", "K10b' ca_coeff_step_cuda"]
        ca, n_ca = counted(sqp_solve_sharded, model, *args, xu, lam0, xs, ee, RHO0,
                           DT, KnotMesh(S))
        it_ca = int(ca.sqp_iters)
        want = {k: it_ca for k in k9_k10 if k.startswith("K9")}
        want.update({k: it_ca * outer for k in k10b})
        ok = all(n_ca[k] == want.get(k, 0) for k in KERNELS)
        ok = ok and all(bool(torch.isfinite(t).all()) for t in
                        (ca.xu, ca.lam, ca.rho, ca.merit))
        expect(ok, f"sharded SQP at its default (ca_slab) N={N} over {S} shards: "
               f"launches {n_ca} (K9a-c once per SQP iteration, {it_ca}; K10b and "
               f"the coefficient step {outer} times per iteration; nothing else); "
               "finite")
        # as pipelined_slab above, and against the plain sharded s-step solve
        # (fused=False, "ca"): the PCG counts within s of pcg_cuda's, its
        # line-search choices, and the distance to f64 per part within 2x
        # the largest of the other f32 solves' + 1e-4
        ca_plain = sqp_solve_sharded(model, *args, xu, lam0, xs, ee, RHO0, DT,
                                     KnotMesh(S), fused=False, pcg_method="ca")
        ec, er = part_errs(ca.xu, f64.xu), part_errs(ca_plain.xu, f64.xu)
        near = all(abs(a - b) <= CA_S for a, b in
                   zip(ca.pcg_iters.tolist(), one.pcg_iters.tolist()))
        same_ls = ca.ls_alpha_idx.tolist() == one.ls_alpha_idx.tolist()
        for key in ("x", "u"):
            lim = 2 * max(er[key], eo[key], ep[key], eq[key], es[key]) + 1e-4
            expect(near and same_ls and ec[key] <= lim,
                   f"sharded SQP (ca_slab) N={N} over {S} shards, {key} part: to f64 "
                   f"{ec[key]:.3e}; plain s-step {er[key]:.3e}, pipelined_slab "
                   f"{es[key]:.3e}, pcg_cuda {eo[key]:.3e}, plain {ep[key]:.3e}, plain "
                   f"sharded {eq[key]:.3e} max|{key}| (<= 2x max + 1e-4); PCG "
                   f"iterations {ca.pcg_iters.tolist()} (pcg_cuda "
                   f"{one.pcg_iters.tolist()}, within {CA_S}; plain s-step "
                   f"{ca_plain.pcg_iters.tolist()}); line search "
                   f"{ca.ls_alpha_idx.tolist()} (pcg_cuda {one.ls_alpha_idx.tolist()}, "
                   f"equal {same_ls})")
        # the s-step collectives and launches per outer step, counted on a
        # solve of the real system by the difference of two caps
        k1_sh = build_kkt_schur(model, cost, xu, xs, ee,
                                torch.full((), RHO0, device=dev), DT, 0)
        per = {}
        for k_cap in (8, 16):
            m_ = KnotMesh(S)
            _, n_ = counted(pcg_solve_sharded, k1_sh["S"], k1_sh["Pinv"],
                            k1_sh["gamma"], lam0, m_, max_iter=k_cap, exit_tol=0.0,
                            method="ca_slab")
            per[k_cap] = (m_.n_send, m_.n_psum, *(n_[k] for k in k10b))
        per_outer = [(b - a) / 2 for a, b in zip(per[8], per[16])]
        expect(per_outer == [2, 1, 1, 1],
               f"s-step PCG N={N} over {S} shards, per outer step of {CA_S} "
               f"iterations: sends, psums, K10b, coefficient-step launches "
               f"{per_outer} (2, 1, 1, 1)")
        ca_run, n_ca_run = counted(sh_loop, SHARD_UPDATES, knot_mesh=KnotMesh(S),
                                   pcg_method="ca_slab")
        it_cr = int(ca_run["sqp_iters"].sum())
        want = {k: it_cr for k in k9_k10 if k.startswith("K9")}
        want.update({k: it_cr * outer for k in k10b})
        want["K4 simulate_plant"] = SHARD_UPDATES
        err_ca = ca_run["tracking_errors"].double().cpu().numpy()
        m_ca = float(err_ca.mean())
        ok = all(n_ca_run[k] == want.get(k, 0) for k in KERNELS)
        ok = ok and len(err_ca) == ROUTE_SHIFTS and finite(err_ca, ca_run["xs_path"])
        ok = ok and abs(m_ca / m_1 - 1) <= 1e-2
        expect(ok, f"sharded loop through ca_slab N={N} over {S} shards, "
               f"{SHARD_UPDATES} updates: launches {n_ca_run}; mean tracking error "
               f"{m_ca:.6g} (within 1% of the single-device loop's {m_1:.6g}); "
               "finite")
        shard_summary[f"N={N} shards={S}"] = dict(
            trace=trace, start_row=start, solve_pcg_iters=sh.pcg_iters.tolist(),
            solve_ls_alpha_idx=sh.ls_alpha_idx.tolist(),
            loop_mean_tracking_error=m_sh, single_loop_mean_tracking_error=m_1,
            loop_sqp_iters=it_run, ca_solve_pcg_iters=ca.pcg_iters.tolist(),
            ca_solve_ls_alpha_idx=ca.ls_alpha_idx.tolist(),
            ca_x_err=ec["x"], ca_u_err=ec["u"], ca_loop_mean_tracking_error=m_ca,
            ca_per_outer_step=per_outer)
        if (N, S) == SHARD_CASES[0]:
            for k in k9_k10:
                launches[k] = n_run[k]
            for k in k10b:
                launches[k] = n_ca_run[k]
    if failures:
        raise SmokeFailure(f"phase 4d: {len(failures)} check(s) failed")

    # ---- phase 4e: the batched closed loop -----------------------------------
    phase(f"phase 4e: batched closed loop, B={B_MAIN}, N={N_MAIN}, trace 0_0 from "
          f"row {CALM_ROW}, {BATCH_UPDATES} updates")
    N = N_MAIN
    cost = CostConfig.for_knots(N)
    bl_kw = dict(sqp_cfg=SQPConfig(max_iter=2),
                 pcg_cfg=PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5))
    # K4b against K4 on every instance, bit for bit (the same device code),
    # and against its plain version on B_PLAIN instances (1e-4 relative)
    plant_args = (2e-3, 2e-3, DT, 10, 2e-4)
    xs4b = xs_b + 0.01 * torch.tensor(np.random.default_rng(2).standard_normal(
        (B_MAIN, 14)), dtype=torch.float32, device=dev)
    k4b = simulate_plant_batched(model, xs4b, xu_b, *plant_args)
    k4 = torch.stack([simulate_plant(model, xs4b[i], xu_b[i], *plant_args)
                      for i in range(B_MAIN)])
    p4b = simulate_plant_batched_plain(model, xs4b[:B_PLAIN], xu_b[:B_PLAIN],
                                       *plant_args)
    torch.cuda.synchronize()
    d4, r4 = rel_err(k4b[:B_PLAIN], p4b)
    errs["K4b simulate_plant_batched"] = d4
    expect(torch.equal(k4b, k4) and r4 <= 1e-4,
           f"K4b B={B_MAIN}: == K4 per instance bit for bit {torch.equal(k4b, k4)}; "
           f"vs plain on {B_PLAIN} instances {r4:.3e} max|ref| (<= 1e-4)")
    # the loop, as a user calls it, unsharded and over the instance axis
    # (make_mesh(n_instance=FLEET_INSTANCES)), every instance bit for bit;
    # BATCH_LOOP_PICKS instances against the single on-device loop from the
    # same start (the trace with its first state moved to the instance's)
    n_bl, batch_summary = fleet_loop_checks(ctx, model, xu_calm, ee_calm, N, B_MAIN,
                                            BATCH_UPDATES, "IIWA", **bl_kw)
    launches["K4b simulate_plant_batched"] = n_bl["K4b simulate_plant_batched"]
    if failures:
        raise SmokeFailure(f"phase 4e: {len(failures)} check(s) failed")

    # ---- phase 4f: the onboarding path at nq = 3, 5 and the URDF IIWA ------
    phase(f"phase 4f: onboarding: 3-link fused SQP, chain tracker nq="
          f"{TRACK_NQ} N={TRACK_KNOTS} ({TRACK_STEPS} rows), nq=3 loop, builtin:iiwa")
    onboard = onboarding_checks(ctx)
    if failures:
        raise SmokeFailure(f"phase 4f: {len(failures)} check(s) failed")

    # ---- phase 4g: the paths of the other kernels at nq = 3, 5 --------------
    phase(f"phase 4g: the fleet (instance axis), the knot-sharded SQP, the split "
          f"routes and pcr_cuda at nq = {NQ_CASES}")
    slice_launches, slice_paths = nq_path_checks(ctx)
    if failures:
        raise SmokeFailure(f"phase 4g: {len(failures)} check(s) failed")

    # ---- phase 4h: the last gaps to the JAX package --------------------------
    phase(f"phase 4h: the H100 cap table at N={N_MAIN} (cap "
          f"{PCGConfig.tuned_max_iter_h100(N_MAIN)}, reference "
          f"{PCGConfig.tuned_max_iter(N_MAIN)}), pcg_solve(precond_poly=2), the "
          f"batched merit_impl")
    gaps = gap_checks(ctx, model, main_run, band_400, xu_traj, ee_traj, xu_calm,
                      ee_calm)
    if failures:
        raise SmokeFailure(f"phase 4h: {len(failures)} check(s) failed")

    # ---- phase 4i: the flags of K3, K9a and K9c ------------------------------
    phase(f"phase 4i: K3 (N={FLAG_K3_N}) with include_zero=False / angle_wrap=True, "
          f"K9a and K9c at {SHARD_CASES} with angle_wrap=True / include_zero=False, "
          f"on joint angles near +-pi")
    flags = flag_checks(ctx, model)
    if failures:
        raise SmokeFailure(f"phase 4i: {len(failures)} check(s) failed")

    # ---- phase 4j: the SQP iteration as a CUDA graph -------------------------
    phase(f"phase 4j: the fused route's CUDA graph per SQP iteration, N={N_MAIN} "
          f"and N={N_BIG}, "
          f"{GRAPH_UPDATES} closed-loop updates against the eager body")
    graph_times = graph_checks(ctx, model)
    if failures:
        raise SmokeFailure(f"phase 4j: {len(failures)} check(s) failed")

    # ---- phase 5: timing ----------------------------------------------------
    phase(f"phase 5: timing at N={N_MAIN} (CUDA events, medians)")
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
    update_us, loop_slopes = slope_us(torch, loop, lo, hi)
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
        # K2 / K2': the device time per CG iteration (the solve's cost
        # beyond its iterations is ~8 us: the loads of S and Pinv)
        steps = {"K2 pcg_dz_solve": int(k2_iters), "K2' pcg_solve_cuda": k2p_iters}
        if name in steps:
            rows[-1]["us_per_iter"] = ms * 1e3 / max(steps[name], 1)
            print(f"    {name}: {rows[-1]['us_per_iter']:.3f} us per CG "
                  f"iteration ({steps[name]} iterations)")

    # this slice: K6 / K9b against the earlier dz_kernel, without PDL, the
    # launch floor and the pairs on their routes (phase 2c's 512/8 inputs)
    n9, s9 = SHARD_CASES[0]
    dz_slice = dz_slice_timings(ctx, sys_, lam_k2, xu[:, 14:], rho, cost.r_cost,
                                pcg_kw["exit_tol"], slab_ref[n9], s9)
    print(f"  {card_line()}")

    # K7 at N_MAIN (its row) and N_BIG on the well-conditioned system (its
    # time does not depend on the values; a dense Cholesky of the real
    # Schur system would fail in f32), beside the dense library solves of
    # the same (14N x 14N) matrix: torch.linalg.solve and Cholesky, the
    # faster one as library_ms (the assembly not timed)
    k7 = {}
    for Nk in (N_MAIN, N_BIG):
        S7, _, b7 = synthetic_btd(Nk, torch, dev)
        dense, rhs = btd_to_dense(S7), b7.reshape(-1, 1)
        p1 = time_ms(torch, lambda: pcr_solve_refined(S7, b7), 5)
        t1 = graph_ms(torch, lambda: pcr_solve_cuda(S7, b7))
        t2 = graph_ms(torch, lambda: pcr_solve_cuda(S7, b7))
        p2 = time_ms(torch, lambda: pcr_solve_refined(S7, b7), 5)
        lib = {"torch.linalg.solve": time_ms(
                   torch, lambda: torch.linalg.solve_ex(dense, rhs), 5),
               "torch.linalg.cholesky + torch.cholesky_solve": time_ms(
                   torch, lambda: torch.cholesky_solve(
                       rhs, torch.linalg.cholesky_ex(dense).L), 5)}
        best = min(lib, key=lib.get)
        k7[Nk] = dict(ms=statistics.median([t1, t2]), plain_ms=statistics.median([p1, p2]),
                      library_ms=lib[best], library=best, bound=pcr_bound(Nk),
                      call_ms=time_ms(torch, lambda: pcr_solve_cuda(S7, b7), 20))
        print(f"  K7 N={Nk}: kernel {k7[Nk]['ms'] * 1e3:.1f} us (device), one call "
              f"{k7[Nk]['call_ms'] * 1e3:.1f} us, plain {k7[Nk]['plain_ms'] * 1e3:.1f} "
              f"us, bound {k7[Nk]['bound'][0] * 1e3:.3f} us ({k7[Nk]['bound'][1]}); "
              + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in lib.items()))
    name = "K7 pcr_solve_cuda"
    rows.append(dict(name=name, route="cuda", source=KERNELS[name][0],
                     replaces=KERNELS[name][1], launches=launches[name],
                     max_abs_err=errs[name], ms=k7[N_MAIN]["ms"],
                     plain_ms=k7[N_MAIN]["plain_ms"], bound_ms=k7[N_MAIN]["bound"][0],
                     bound_by=k7[N_MAIN]["bound"][1],
                     library_ms=k7[N_MAIN]["library_ms"],
                     library=k7[N_MAIN]["library"], call_ms=k7[N_MAIN]["call_ms"],
                     n512={k: (v[0] if k == "bound" else v)
                           for k, v in k7[N_BIG].items()}))

    # K8a-c and K3b at B_MAIN instances of N_MAIN knots, on phase 2b's inputs
    # (K8b from the cold start, as the first SQP iteration); each plain
    # version (B_MAIN single-instance plain calls) is timed once
    bounds.update(batched_bounds(N_MAIN, B_MAIN, int((it_b.long() + 1).sum())))
    u_b = xu_b[:, :, 14:]
    b_pairs = {
        "K8a build_kkt_schur_batched": (
            lambda: build_kkt_schur_batched(model, cost, xu_b, xs_b, ee_b, rho_b, DT),
            lambda: build_kkt_schur_batched_plain(model, cost, xu_b, xs_b, ee_b,
                                                  rho_b, DT)),
        "K8b pcg_solve_batched": (
            lambda: pcg_solve_batched(sys_b["S"], sys_b["Pinv"], sys_b["gamma"],
                                      lam0_b, **pcg_b),
            lambda: pcg_solve_batched_plain(sys_b["S"], sys_b["Pinv"],
                                            sys_b["gamma"], lam0_b, **pcg_b)),
        "K8c compute_dz_batched": (
            lambda: compute_dz_batched(sys_b, lam_b, u_b, rho_b, cost.r_cost),
            lambda: compute_dz_batched_plain(sys_b, lam_b, u_b, rho_b, cost.r_cost)),
        "K3b line_search_merits_batched": (
            lambda: line_search_merits_batched(model, cost, xu_b, dz_b, xs_b, ee_b,
                                               mu, DT),
            lambda: line_search_merits_batched_plain(model, cost, xu_b, dz_b, xs_b,
                                                     ee_b, mu, DT)),
    }
    for name, (kern, plain_fn) in b_pairs.items():
        ms = statistics.median([graph_ms(torch, kern), graph_ms(torch, kern)])
        plain_ms = once_ms(torch, plain_fn)
        bound_ms, bound_by = bounds[name]
        print(f"  {name} (B={B_MAIN}): kernel {ms * 1e3:.1f} us (device), plain "
              f"{plain_ms * 1e3:.1f} us (one call), bound {bound_ms * 1e3:.3f} us "
              f"({bound_by})")
        rows.append(dict(name=name, route="cuda", source=KERNELS[name][0],
                         replaces=KERNELS[name][1], launches=launches[name],
                         max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        if name == "K8b pcg_solve_batched":
            # per CG iteration of the slowest instance (the clusters run in
            # waves: cudaOccupancyMaxActiveClusters at a time)
            rows[-1]["us_per_iter"] = ms * 1e3 / max(int(it_b.max()), 1)
            print(f"    {name}: {rows[-1]['us_per_iter']:.3f} us per CG iteration "
                  f"of the slowest instance ({int(it_b.max())} iterations; "
                  f"{int(it_b.sum())} over the {B_MAIN} instances)")

    # the pcr_cuda loop per control update (on the device, as the main path,
    # on the calm rows as phase 4b)
    pcr_update_us, pcr_slopes = slope_us(
        torch, lambda k: simulate_mpc_ondevice(
            model, xu_calm, ee_calm, N_MAIN, DT,
            sim_cfg=SimConfig(max_control_updates=k), linsys="pcr_cuda", **loop_kw),
        *LOOP_SLOPE)
    print(f"  pcr_cuda on-device loop per control update (slope {LOOP_SLOPE}): "
          f"{pcr_update_us:.1f} us (runs: {', '.join(f'{v:.1f}' for v in pcr_slopes)})")
    # the batched solve per SQP iteration (slope between 1 and 3 iterations)
    # against B_MAIN single fused solves of one iteration, one after another
    def batched_run(iters):
        make_batched_sqp_solver(model, cost, SQPConfig(max_iter=iters), pcg_cfg,
                                DT)(xu_b, lam0_b, xs_b, ee_b, rho_b)

    def singles():
        for i in range(B_MAIN):
            sqp_solve(model, cost, SQPConfig(max_iter=1), pcg_cfg, xu_b[i], lam0_b[i],
                      xs_b[i], ee_b[i], rho_b[i], DT, linsys="pcg_cuda")

    batch_iter_us, batch_slopes = slope_us(torch, batched_run, 1, 3)
    singles()
    single_us = statistics.median(once_ms(torch, singles) for _ in range(3)) * 1e3
    batch_solves = B_MAIN / (batch_iter_us * 1e-6)
    print(f"  batched solve B={B_MAIN}: {batch_iter_us:.1f} us per SQP iteration "
          f"(runs: {', '.join(f'{v:.1f}' for v in batch_slopes)}) = "
          f"{batch_solves:.0f} instance-iterations/s; {B_MAIN} single fused "
          f"one-iteration solves {single_us:.1f} us; ratio "
          f"{batch_iter_us / single_us:.4f}")

    # the slab kernels at both shard cases on phase 2c's inputs; K10a is
    # timed in its init mode (alpha = beta = 0, the whole step's work, no
    # exit test), whose state a graph of repeated calls keeps finite; the
    # plain versions one call at a time
    shard_rows = {}
    for N, S in SHARD_CASES:
        r_ = slab_ref[N]
        cost, rho, L = r_["cost"], r_["rho"], N // S
        sc = lambda t: t.reshape(S, L, *t.shape[1:])
        k1 = r_["k1"]
        mesh = KnotMesh(S)
        PL = mesh.send_right(sc(k1["Pinv"])[:, -1])
        PR = mesh.send_left(sc(k1["Pinv"])[:, 0])
        st = slab_state(torch.zeros_like(sc(k1["gamma"])), sc(k1["gamma"]))
        pk = torch.zeros((S, 6, 14), device=dev)
        tol0 = _kernels.scalar(0.0, dev)
        st_plain = {k: v.clone() for k, v in st.items()}
        k10 = lambda step, state: step(state, sc(k1["S"]), sc(k1["Pinv"]), pk, pk,
                                       PL, PR, state["dots"], 1, tol0, "eta", True)
        sb = shard_bounds(N, S)
        pairs_s = {
            "K9a build_kkt_schur_slab": (
                lambda: build_kkt_schur_slab(model, cost, r_["xe"], r_["ee"],
                                             r_["first"], r_["last"], rho, DT),
                lambda: build_kkt_schur_slab_plain(model, cost, r_["xe"], r_["ee"],
                                                   r_["first"], r_["last"], rho, DT)),
            "K9b compute_dz_slab": (
                lambda: compute_dz_slab(r_["sl"], r_["lam_s"], r_["lam_n"],
                                        r_["last_s"], r_["u_s"], rho, cost.r_cost),
                lambda: compute_dz_slab_plain(r_["sl"], r_["lam_s"], r_["lam_n"],
                                              r_["last_s"], r_["u_s"], rho,
                                              cost.r_cost)),
            "K9c line_search_merit_partials_slab": (
                lambda: line_search_merit_partials_slab(model, cost, r_["x1"],
                                                        r_["z1"], r_["e1"], DT),
                lambda: merit_partials(model, cost, r_["x1"], r_["z1"], r_["e1"], DT)),
            "K10a pcg_slab_step_cuda": (lambda: k10(pcg_slab_step_cuda, st),
                                        lambda: k10(pcg_slab_step, st_plain)),
        }
        for name, (kern, plain_fn) in pairs_s.items():
            p1 = time_ms(torch, plain_fn, 3)
            ms = statistics.median([graph_ms(torch, kern), graph_ms(torch, kern)])
            p2 = time_ms(torch, plain_fn, 3)
            bound_ms, bound_by = sb[name]
            shard_rows.setdefault(name, {})[N] = dict(
                ms=ms, plain_ms=statistics.median([p1, p2]), bound_ms=bound_ms,
                bound_by=bound_by)
            print(f"  {name} N={N} over {S} shards: kernel {ms * 1e3:.1f} us "
                  f"(device), plain {statistics.median([p1, p2]) * 1e3:.1f} us, "
                  f"bound {bound_ms * 1e3:.3f} us ({bound_by})")
    for name, per_n in shard_rows.items():
        main = per_n[SHARD_CASES[0][0]]
        rows.append(dict(name=name, route="cuda", source=KERNELS[name][0],
                         replaces=KERNELS[name][1], launches=launches[name],
                         max_abs_err=errs[name], ms=main["ms"],
                         plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                         bound_by=main["bound_by"], library_ms=None,
                         n64=per_n[SHARD_CASES[1][0]]))

    # the knot-sharded solve per SQP iteration (slope between 1 and 3
    # iterations) against the single-device pcg_cuda solve, and the
    # knot-sharded on-device loop per control update (slope over two loop
    # lengths), at both cases from phase 4d's start rows
    for N, S in SHARD_CASES:
        trace, start = SHARD_START[N]
        cost = CostConfig.for_knots(N)
        pcfg = PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)
        xu, xs, ee, _ = problem(N, torch, dev, 0, start, trace)
        lam0 = torch.zeros((N, 14), dtype=torch.float32, device=dev)
        sharded_it, sh_runs = slope_us(torch, lambda k: sqp_solve_sharded(
            model, cost, SQPConfig(max_iter=k), pcfg, xu, lam0, xs, ee, RHO0, DT,
            KnotMesh(S), pcg_method="pipelined"), 1, 3)
        single_it, one_runs = slope_us(torch, lambda k: sqp_solve(
            model, cost, SQPConfig(max_iter=k), pcfg, xu, lam0, xs, ee, RHO0, DT,
            linsys="pcg_cuda"), 1, 3)
        upd_us, upd_runs = slope_us(torch, lambda k: simulate_mpc_ondevice(
            model, load_xu_traj(trace)[start:start + N + LOOP_ROWS],
            load_eepos_traj(trace)[start:start + N + LOOP_ROWS], N, DT,
            sim_cfg=SimConfig(max_control_updates=k), knot_mesh=KnotMesh(S),
            sqp_cfg=SQPConfig(max_iter=2, max_time_us=None), pcg_cfg=pcfg),
            *SHARD_SLOPE)
        key = f"N={N} shards={S}"
        shard_summary[key].update(sqp_iter_us=sharded_it, single_sqp_iter_us=single_it,
                                  update_us=upd_us)
        print(f"  sharded N={N} over {S} shards: {sharded_it:.1f} us per SQP "
              f"iteration (runs {', '.join(f'{v:.1f}' for v in sh_runs)}) against "
              f"pcg_cuda {single_it:.1f} us (runs "
              f"{', '.join(f'{v:.1f}' for v in one_runs)}); on-device loop "
              f"{upd_us:.1f} us per control update (runs "
              f"{', '.join(f'{v:.1f}' for v in upd_runs)})")

    # K10b and the coefficient step per call (one outer step of s
    # iterations) at both shard cases, on phase 2c's real system at its
    # second outer step: device time of a CUDA graph (the coefficient step
    # advances its state each call, never to the cap), the plain versions
    # one call at a time
    ca_rows = {}
    for N, S in SHARD_CASES:
        k1 = slab_ref[N]["k1"]
        mesh = KnotMesh(S)
        st, ins = ca_setup(mesh, k1["S"], k1["Pinv"], k1["gamma"])
        tot = mesh.psum(st["parts"])
        st_k, st_p = clone_state(st), clone_state(st)
        cb = ca_bounds(N, S)
        pairs_ca = {
            "K10b ca_basis_cuda": (
                lambda: ca_basis_cuda(st_k, *ins, CA_CAP, CA_S),
                lambda: ca_basis(st_p, *ins, CA_CAP, CA_S)),
            "K10b' ca_coeff_step_cuda": (
                lambda: ca_coeff_step_cuda(st_k, tot, CA_CAP, tol0, "eta", CA_S),
                lambda: ca_coeff_step(st_p, tot, CA_CAP, tol0, "eta", CA_S)),
        }
        for name, (kern, plain_fn) in pairs_ca.items():
            p1 = time_ms(torch, plain_fn, 3)
            ms = statistics.median([graph_ms(torch, kern), graph_ms(torch, kern)])
            p2 = time_ms(torch, plain_fn, 3)
            bound_ms, bound_by = cb[name]
            ca_rows.setdefault(name, {})[N] = dict(
                ms=ms, plain_ms=statistics.median([p1, p2]), bound_ms=bound_ms,
                bound_by=bound_by)
            print(f"  {name} N={N} over {S} shards: kernel {ms * 1e3:.1f} us "
                  f"(device), plain {statistics.median([p1, p2]) * 1e3:.1f} us, "
                  f"bound {bound_ms * 1e3:.3f} us ({bound_by})")
    for name, per_n in ca_rows.items():
        main = per_n[SHARD_CASES[0][0]]
        rows.append(dict(name=name, route="cuda", source=KERNELS[name][0],
                         replaces=KERNELS[name][1], launches=launches[name],
                         max_abs_err=errs[name], ms=main["ms"],
                         plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                         bound_by=main["bound_by"], library_ms=None,
                         n64=per_n[SHARD_CASES[1][0]]))

    # the sharded solve at its default (ca_slab) per SQP iteration and its
    # on-device loop per update, as above
    for N, S in SHARD_CASES:
        trace, start = SHARD_START[N]
        cost = CostConfig.for_knots(N)
        pcfg = PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)
        xu, xs, ee, _ = problem(N, torch, dev, 0, start, trace)
        lam0 = torch.zeros((N, 14), dtype=torch.float32, device=dev)
        ca_it, ca_runs = slope_us(torch, lambda k: sqp_solve_sharded(
            model, cost, SQPConfig(max_iter=k), pcfg, xu, lam0, xs, ee, RHO0, DT,
            KnotMesh(S)), 1, 3)
        ca_upd, ca_upd_runs = slope_us(torch, lambda k: simulate_mpc_ondevice(
            model, load_xu_traj(trace)[start:start + N + LOOP_ROWS],
            load_eepos_traj(trace)[start:start + N + LOOP_ROWS], N, DT,
            sim_cfg=SimConfig(max_control_updates=k), knot_mesh=KnotMesh(S),
            pcg_method="ca_slab", sqp_cfg=SQPConfig(max_iter=2, max_time_us=None),
            pcg_cfg=pcfg), *SHARD_SLOPE)
        key = f"N={N} shards={S}"
        shard_summary[key].update(ca_sqp_iter_us=ca_it, ca_update_us=ca_upd)
        print(f"  sharded N={N} over {S} shards, ca_slab: {ca_it:.1f} us per SQP "
              f"iteration (runs {', '.join(f'{v:.1f}' for v in ca_runs)}) against "
              f"pipelined_slab {shard_summary[key]['sqp_iter_us']:.1f} and pcg_cuda "
              f"{shard_summary[key]['single_sqp_iter_us']:.1f}; on-device loop "
              f"{ca_upd:.1f} us per control update (runs "
              f"{', '.join(f'{v:.1f}' for v in ca_upd_runs)}; pipelined_slab "
              f"{shard_summary[key]['update_us']:.1f})")

    # K4b at B_MAIN instances (phase 4e's inputs) against its plain version
    # (B_MAIN plain plants, one call), and the batched loop per update
    # (slope over two loop lengths) in instance-updates/s
    k4b_bound = plant_batched_bound(B_MAIN, len({
        min(int((2e-3 + i * 2e-4) / DT), N_MAIN - 1) for i in range(11)}), 11)
    k4b_ms = statistics.median([graph_ms(torch, lambda: simulate_plant_batched(
        model, xs4b, xu_b, *plant_args)) for _ in range(2)])
    k4b_plain = once_ms(torch, lambda: simulate_plant_batched_plain(
        model, xs4b, xu_b, *plant_args))
    print(f"  K4b simulate_plant_batched (B={B_MAIN}): kernel {k4b_ms * 1e3:.1f} us "
          f"(device), plain {k4b_plain * 1e3:.1f} us (one call), bound "
          f"{k4b_bound[0] * 1e3:.4f} us ({k4b_bound[1]})")
    rows.append(dict(name="K4b simulate_plant_batched", route="cuda",
                     source=KERNELS["K4b simulate_plant_batched"][0],
                     replaces=KERNELS["K4b simulate_plant_batched"][1],
                     launches=launches["K4b simulate_plant_batched"],
                     max_abs_err=errs["K4b simulate_plant_batched"], ms=k4b_ms,
                     plain_ms=k4b_plain, bound_ms=k4b_bound[0],
                     bound_by=k4b_bound[1], library_ms=None))
    # the fleet, unsharded and over the instance axis, in turns
    fleet_us = {}
    for name, mesh in (("unsharded", None), ("instance-sharded", True),
                       ("instance-sharded", True), ("unsharded", None)):
        upd, runs_ = slope_us(torch, lambda k: simulate_mpc_ondevice_batched(
            model, xu_calm, ee_calm, N_MAIN, DT, B_MAIN,
            sim_cfg=SimConfig(max_control_updates=k),
            instance_mesh=mesh and make_mesh(n_instance=FLEET_INSTANCES), **bl_kw),
            *BATCH_SLOPE)
        fleet_us.setdefault(name, []).append(upd)
        print(f"  batched loop B={B_MAIN}, {name}: {upd:.1f} us per control update "
              f"(runs {', '.join(f'{v:.1f}' for v in runs_)}); {card_line()}")
    bl_upd = statistics.median(fleet_us["unsharded"])
    batch_summary.update(update_us=bl_upd,
                         instance_updates_per_s=B_MAIN / (bl_upd * 1e-6),
                         instance_sharded_update_us=statistics.median(
                             fleet_us["instance-sharded"]))
    print(f"  batched loop B={B_MAIN}: {bl_upd:.1f} us per control update = "
          f"{batch_summary['instance_updates_per_s']:.0f} instance-updates/s; over "
          f"make_mesh(n_instance={FLEET_INSTANCES}) "
          f"{batch_summary['instance_sharded_update_us']:.1f} us")
    # the 5-link fleet (phase 4g's), unsharded
    m5 = chain_model(TRACK_NQ, torch, dev)
    xu5, ee5 = track_chain.reference_trace(m5, TRACK_STEPS)
    upd5, runs5 = slope_us(torch, lambda k: simulate_mpc_ondevice_batched(
        m5, xu5, ee5, N_MAIN, DT, B_MAIN, sim_cfg=SimConfig(max_control_updates=k),
        cost=track_chain.COST, sqp_cfg=track_chain.DEVICE_SQP,
        pcg_cfg=track_chain.PCG), *BATCH_SLOPE)
    slice_paths[TRACK_NQ]["fleet"]["update_us"] = upd5
    print(f"  batched loop nq={TRACK_NQ} B={B_MAIN} N={N_MAIN}: {upd5:.1f} us per "
          f"control update (runs {', '.join(f'{v:.1f}' for v in runs5)}); "
          f"{card_line()}")

    # every kernel at the chains' joint counts: each row of the kernels line
    # says the nq values its kernel was checked at on the card and gives its
    # numbers at nq = 3, 5 beside the IIWA's
    for nq in NQ_CASES:          # K4b's launches at nq = 3, 5: phase 4g's fleets
        onboard["launches"][nq]["K4b simulate_plant_batched"] = \
            slice_launches[nq]["K4b simulate_plant_batched"]
    nq_rows = nq_timings(ctx, onboard["launches"], errs_nq)
    slice_rows = slice_timings(ctx, slice_launches, errs_slice)
    for row in rows:
        per_nq = nq_rows if row["name"] in NQ_KERNELS else slice_rows
        row["nq_checked"] = sorted(NQ_CASES + (7,))
        row["nq"] = {str(nq): per_nq[nq][row["name"]] for nq in NQ_CASES}

    # ---- phase 7: the multi-card path ----------------------------------------
    world = min(MULTI_CARDS, torch.cuda.device_count())
    phase(f"phase 7: multi-card: {world} worker process(es), one card each, "
          "in one NCCL group")
    multi = multicard_checks(ctx)
    if failures:
        raise SmokeFailure(f"phase 7: {len(failures)} check(s) failed")
    for row in rows:             # the cards each kernel ran on: phase 7's, else card 0
        row["cards"] = multi["cards"][row["name"]] or 1

    # ---- phase 6: results -----------------------------------------------
    print(json.dumps({"kernels": rows, "chain_step_us": step_us,
                      "mean_pcg_iters": it_k, "plain_mean_pcg_iters": it_p,
                      "loop_update_us": update_us,
                      "host_avg_sqp_time_us": hs["avg_sqp_time_us"],
                      "loop_mean_tracking_error": float(err_dev.mean()),
                      "adaptive_per_iter_us": ada["per_iter_us"],
                      "direct_loops": direct_summary,
                      "pcr_cuda_loop_update_us": pcr_update_us,
                      "batched_iter_us": batch_iter_us,
                      "batched_instance_iters_per_s": batch_solves,
                      "batched_singles_us": single_us,
                      "sharded": shard_summary,
                      "batched_loop": batch_summary,
                      "onboarding": onboard,
                      "nq_paths": slice_paths,
                      "dz_slice_us": dz_slice,
                      "gaps": gaps,
                      "flags": flags, "graph": graph_times,
                      "multicard": multi,
                      "card": card}))
    phase("chip_smoke: done")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multicard-worker"]:
        sys.exit(multicard_worker(sys.argv[2:]))
    sys.exit(main())
