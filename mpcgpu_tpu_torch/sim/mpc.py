"""Closed-loop MPC simulator: solve -> simulate plant -> shift -> repeat.

Port of ``mpcgpu_tpu/sim/mpc.py``, the equivalent of simulateMPC
(include/mpcsim.cuh:146-426) and simple_simulate
(include/common/integrator.cuh:295-325):

  * ``simulate_mpc``: the host control loop, with the reference's timing
    semantics (CONST_UPDATE_FREQ, settings.cuh:56-72, mpcsim.cuh:280-284):
    each control update advances the plant by the simulation period (or, in
    adaptive mode, by the measured solve time) using the PREVIOUS plan's
    controls offset by the previous sim time, then shifts the plan, goal and
    multipliers once per trajectory timestep;
  * ``simulate_mpc_ondevice``: the same loop as device work that reads
    nothing back per control step (constant frequency: the shift schedule is
    precomputed on the host; adaptive frequency: the solve time is modelled
    as base_us + per_iter_us * sqp_iters and the schedule stays on the
    device); with ``knot_mesh``, every solve knot-sharded
    (``parallel/sqp_sharded.py``);
  * ``simulate_mpc_ondevice_batched``: B such loops from perturbed starts at
    once on the shared constant-frequency schedule, every update one
    batched solve (``parallel/batched_cuda.py``, K8a-c and K3b) and one
    plant launch over the instances (K4b);
  * ``run_chain``: the warm-started chain that ``bench.py`` times (no plant).

The plant is K4 (``sim/plant_cuda.py::simulate_plant``; K4b
``simulate_plant_batched`` over instances) on CUDA tensors and its plain
version ``simulate_plant_plain`` (the JAX package's ``_simulate_plant``) on
CPU tensors.  Every entry point computes on the
model's device.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.parallel.batched_cuda import sqp_solve_batched_fused
from mpcgpu_tpu_torch.parallel.sqp_sharded import make_sharded_sqp_solver
from mpcgpu_tpu_torch.sim.plant_cuda import simulate_plant, simulate_plant_batched
from mpcgpu_tpu_torch.solver.sqp import make_sqp_solver, sqp_solve


def _ee_xyz(model: RobotModel, q):
    """The end-effector position of q (..., nq): the joint transforms applied
    to the homogeneous origin from the last to the first, each product
    written out elementwise, so that it rounds alike at any batch shape (a
    batched matrix product and a single one round differently on the card,
    and B loops at once must track as B single loops)."""
    H = model.hom_xmats(q)
    v = H[..., -1, :, 3]
    for k in range(model.nq - 2, -1, -1):
        Hk = H[..., k, :, :]
        v = ((Hk[..., 0] * v[..., 0:1] + Hk[..., 1] * v[..., 1:2])
             + Hk[..., 2] * v[..., 2:3]) + Hk[..., 3] * v[..., 3:4]
    return v[..., :3]


def _tracking_error(model: RobotModel, xs, ee_goal):
    """L1 ee position error of the measured state against the goal window's
    first row (mpcsim.cuh:300-309): xs (..., nx), ee_goal (..., N, 6) ->
    (...)."""
    return (_ee_xyz(model, xs[..., :model.nq]) - ee_goal[..., 0, :3]).abs().sum(-1)


def _resolve_linsys(linsys: str, device) -> str:
    """"auto" is the kernels' PCG ("pcg_cuda") on the card and the plain
    PCG ("pcg") on the CPU."""
    if linsys == "auto":
        return "pcg_cuda" if torch.device(device).type == "cuda" else "pcg"
    return linsys


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _pin_state(xu, xs):
    """xu (..., N, nx+nu) with its first state row set to the measured state
    xs (..., nx) (mpcsim.cuh:348); a new tensor, since the old plan may
    still drive the plant."""
    xu = xu.clone()
    xu[..., 0, :xs.shape[-1]] = xs
    return xu


def _shift_all(xu, lam, ee_goal, backfill_xu, backfill_goal):
    """Warm-start shift: plan, goal and multipliers (..., N, .) move left one
    knot; the tails are backfilled (xu and goal from the given rows, shared
    by every instance, lam duplicated)."""
    tail = lambda v, row: torch.cat([v[..., 1:, :], row.expand_as(v[..., :1, :])], -2)
    return (tail(xu, backfill_xu), tail(lam, lam[..., -1:, :]),
            tail(ee_goal, backfill_goal))


def _shift_rule(clock, shifted, sim_time, timestep, threshold):
    """The reference's shift schedule for one control update
    (mpcsim.cuh:296-330): the clock gains the update's sim time; the goal
    shifts at the first update of each trajectory timestep whose clock
    passes the threshold; the clock wraps modulo the timestep.  On numpy
    scalars on the host (np.float64 clock, np.bool_ shifted) or 0-d tensors
    on the device.  Returns (do_shift, clock, shifted)."""
    xp = torch if torch.is_tensor(clock) else np
    clock = clock + sim_time
    do_shift = ~shifted & (clock > threshold)
    wrap = clock > timestep
    shifted = (shifted | do_shift) & ~wrap
    clock = xp.where(wrap, xp.remainder(clock, timestep), clock)
    return do_shift, clock, shifted


def _backfill(xu_traj, ee_traj, nq: int, offsets, N: int):
    """The rows a shift appends at trajectory offsets ``offsets`` (int64
    (k,) on the trajectories' device): the horizon END index's rows (the
    consistent warm start; the reference uses the start index,
    mpcsim.cuh:316) or, past the trajectory's end, its last joint positions
    with zero velocities and controls, and its last goal.  Returns tails
    (k, nx+nu) and goal tails (k, 6)."""
    steps = xu_traj.shape[0]
    idx = torch.clamp(offsets + N - 1, max=steps - 1)
    rest = torch.zeros_like(xu_traj[-1])
    rest[:nq] = xu_traj[-1, :nq]
    tails = torch.where((offsets + N < steps)[:, None],
                        xu_traj.index_select(0, idx), rest)
    return tails, ee_traj.index_select(0, idx)


def _control_update(model, res, xs, xu_old, ee_goal, t_off, sim_t, timestep,
                    n_sub, sim_step, shift=None, when=None, record=False):
    """One control update after the solve ``res`` (mpcsim.cuh:280-348): K4
    rolls the plant over sim_t under the previous plan xu_old, offset by the
    previous sim time t_off; with ``shift = (tail, goal_tail)`` the tracking
    error is taken against the goal before it moves, and plan, goal and
    multipliers shift (where the 0-d bool tensor ``when`` holds, if given);
    then the plan's first state is pinned to the measured state.  Returns
    (xs, xu, lam, ee_goal, err); err is None without a shift unless
    ``record``."""
    xs = simulate_plant(model, xs, xu_old, t_off, sim_t, timestep, n_sub,
                        sim_step)
    xu, lam, err = res.xu, res.lam, None
    if shift is not None or record:
        err = _tracking_error(model, xs, ee_goal)
    if shift is not None:
        moved = _shift_all(xu, lam, ee_goal, *shift)
        if when is not None:
            moved = tuple(torch.where(when, a, b)
                          for a, b in zip(moved, (xu, lam, ee_goal)))
        xu, lam, ee_goal = moved
    return xs, _pin_state(xu, xs), lam, ee_goal, err


@dataclasses.dataclass
class MPCStats:
    """Reference metric set (mpcsim.cuh:358-394)."""

    linsys_iters: list
    linsys_exits: list
    sqp_times_us: list
    sqp_iters: list
    sqp_exits: list
    tracking_errors: list
    tracking_path: list
    final_tracking_error: float = float("nan")

    def summary(self) -> dict:
        te = np.asarray(self.tracking_errors, dtype=np.float64)
        st = np.asarray(self.sqp_times_us, dtype=np.float64)
        it = np.concatenate([np.asarray(v) for v in self.linsys_iters]) \
            if self.linsys_iters else np.zeros(0)
        ex = np.concatenate([np.asarray(v) for v in self.linsys_exits]) \
            if self.linsys_exits else np.zeros(0)
        return dict(
            avg_tracking_error=float(te.mean()) if te.size else float("nan"),
            final_tracking_error=self.final_tracking_error,
            avg_sqp_time_us=float(st.mean()) if st.size else float("nan"),
            avg_sqp_iters=float(np.mean(self.sqp_iters)) if self.sqp_iters else float("nan"),
            avg_pcg_iters=float(it.mean()) if it.size else float("nan"),
            pcg_maxiter_exit_pct=float(100.0 * (1.0 - ex.mean())) if ex.size else float("nan"),
            control_updates=len(self.sqp_times_us),
        )


def _finalize_stats(stats: MPCStats) -> None:
    """Bring the deferred device values to the host (one sync at the end)."""
    stack = lambda vals: torch.stack(vals).cpu().numpy()
    sqp_iters = [int(v) for v in stack(stats.sqp_iters)] if stats.sqp_iters else []
    iters_np = stack(stats.linsys_iters) if stats.linsys_iters else np.zeros((0, 1))
    exits_np = stack(stats.linsys_exits) if stats.linsys_exits else np.zeros((0, 1))
    stats.linsys_iters = [iters_np[i, :n] for i, n in enumerate(sqp_iters)]
    stats.linsys_exits = [exits_np[i, :n] for i, n in enumerate(sqp_iters)]
    stats.sqp_iters = sqp_iters
    stats.sqp_exits = [bool(v) for v in stack(stats.sqp_exits)] if stats.sqp_exits else []
    stats.tracking_errors = ([float(v) for v in stack(stats.tracking_errors)]
                             if stats.tracking_errors else [])
    stats.tracking_path = list(stack(stats.tracking_path))


def calibrate_sqp_iteration_us(
    model: RobotModel, cost, sqp_cfg, pcg_cfg, timestep, linsys,
    xu, lam, xs, ee_goal, rho, chain_len: int = 32, reps: int = 3,
    integrator_type: int = 0, **route,
) -> float:
    """The mean time of ONE SQP iteration (us): ``chain_len`` 1-iteration
    solves, each fed the previous result, after one warm chain; the median
    over ``reps`` chains.  Timed with CUDA events on the card (the host
    clock on the CPU).  The on-device time budget converts SQP_MAX_TIME_US
    into an iteration cap with it (sqpTimecheck, pcg/sqp.cuh:161-169).
    ``route`` (merit_impl, fused, fused_dz) goes to ``sqp_solve``."""
    dev = xu.device
    linsys = _resolve_linsys(linsys, dev)

    def chain():
        xu_, lam_, rho_ = xu, lam, rho
        for _ in range(chain_len):
            res = sqp_solve(model, cost, sqp_cfg, pcg_cfg, xu_, lam_, xs,
                            ee_goal, rho_, timestep, linsys=linsys,
                            max_sqp_iter=1, integrator_type=integrator_type,
                            **route)
            xu_, lam_, rho_ = res.xu, res.lam, res.rho

    chain()
    _sync(dev)
    samples = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            chain()
            b.record()
            torch.cuda.synchronize(dev)
            samples.append(a.elapsed_time(b) * 1e3 / chain_len)
        else:
            t0 = time.perf_counter()
            chain()
            samples.append((time.perf_counter() - t0) * 1e6 / chain_len)
    return float(statistics.median(samples))


def simulate_mpc(
    model: RobotModel,
    xu_traj: np.ndarray,          # (traj_steps, nx+nu) precomputed trajectory
    eepos_traj: np.ndarray,       # (traj_steps, 6) ee goal trace
    knot_points: int,
    timestep: float,
    cost: Optional[CostConfig] = None,
    sqp_cfg: SQPConfig = SQPConfig(),
    pcg_cfg: Optional[PCGConfig] = None,
    sim_cfg: SimConfig = SimConfig(),
    linsys: str = "auto",
    linsys_exit_tol: Optional[float] = None,
    dtype=None,
    verbose: bool = False,
    **route,
) -> MPCStats:
    """Track the recorded trajectory closed-loop with a host control loop;
    returns reference-style stats.

    Computes on the model's device in ``dtype`` (default: the model's).
    ``linsys="auto"`` is ``"pcg_cuda"`` on the card (the fused kernels
    K1 -> K2 -> K3) and ``"pcg"`` on the CPU.  (The JAX package's default
    ``"pcg"`` reaches K5 and K3 on the TPU; here ``linsys="pcg"`` on the
    card does the same.)  The direct solvers are ``"ldl"``, ``"pcr"``,
    ``"pcr_cuda"`` (the PCR kernel K7) and ``"qdldl_host"`` (a host round
    trip per SQP iteration); ``linsys_exit_tol`` replaces the PCG exit
    tolerance.  ``route`` (merit_impl, fused, fused_dz) goes to
    ``sqp_solve``.  Each solve's wall time is taken after
    ``torch.cuda.synchronize()``.
    """
    N = knot_points
    nq = model.nq
    nx = 2 * nq
    dev = model.xc.device
    dtype = model.dtype if dtype is None else dtype
    traj_steps = xu_traj.shape[0]
    cost = cost or CostConfig.for_knots(N)
    pcg_cfg = pcg_cfg or PCGConfig(max_iter=PCGConfig.tuned_max_iter(N))
    if linsys_exit_tol is not None:
        pcg_cfg = dataclasses.replace(pcg_cfg, exit_tol=linsys_exit_tol)
    linsys = _resolve_linsys(linsys, dev)

    xu_traj_t = torch.tensor(xu_traj, dtype=dtype, device=dev)
    ee_traj_t = torch.tensor(eepos_traj, dtype=dtype, device=dev)
    xu = xu_traj_t[:N]
    xu_old = xu
    ee_goal = ee_traj_t[:N]
    lam = torch.zeros((N, nx), dtype=dtype, device=dev)
    xs = xu[0, :nx]
    rho = _kernels.scalar(1e-3, dev, dtype)

    solver = make_sqp_solver(model, cost, sqp_cfg, pcg_cfg, timestep,
                             linsys=linsys, **route)
    if sim_cfg.time_budget_mode and sim_cfg.time_budget_impl == "ondevice":
        # one calibration -> an iteration cap; each solve stays one call
        per_iter_us = calibrate_sqp_iteration_us(
            model, cost, sqp_cfg, pcg_cfg, timestep, linsys,
            xu, lam, xs, ee_goal, rho, **route)
        budget = max(1, min(sqp_cfg.max_iter,
                            int((sqp_cfg.max_time_us or 2000.0) / per_iter_us)))
        if verbose:
            print(f"[budget] {per_iter_us:.0f} us/SQP-iteration calibrated -> "
                  f"iteration budget {budget}")
        base_solver = solver

        def solver(xu, lam, xs, ee_goal, rho):
            return base_solver(xu, lam, xs, ee_goal, rho, 1.0, budget)

    elif sim_cfg.time_budget_mode:
        solver_1 = make_sqp_solver(
            model, cost, dataclasses.replace(sqp_cfg, max_iter=1), pcg_cfg,
            timestep, linsys=linsys, **route)

        def solver(xu, lam, xs, ee_goal, rho):
            """Chunked 1-iteration solves under the SQP_MAX_TIME_US wall cap
            (stage-granular in the reference, iteration-granular here)."""
            budget_s = (sqp_cfg.max_time_us or 2000.0) * 1e-6
            t0 = time.perf_counter()
            agg_iters, agg_conv, agg_alpha = [], [], []
            drho = _kernels.scalar(1.0, dev, dtype)
            for _ in range(sqp_cfg.max_iter):
                res = solver_1(xu, lam, xs, ee_goal, rho, drho)
                _sync(dev)
                xu, lam, rho, drho = res.xu, res.lam, res.rho, res.drho
                agg_iters.append(int(res.pcg_iters[0]))
                agg_conv.append(bool(res.pcg_converged[0]))
                agg_alpha.append(int(res.ls_alpha_idx[0]))
                if bool(res.gave_up) or time.perf_counter() - t0 > budget_s:
                    break
            n = len(agg_iters)
            pad = sqp_cfg.max_iter - n
            as_int = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
            return res._replace(
                xu=xu, lam=lam, rho=rho, sqp_iters=as_int(n),
                pcg_iters=as_int(agg_iters + [-1] * pad),
                pcg_converged=torch.tensor(agg_conv + [False] * pad, device=dev),
                ls_alpha_idx=as_int(agg_alpha + [-1] * pad))

    # static substep budget; the clip schedule of the plant integrates any
    # sim time up to it exactly (adaptive mode uses the measured solve time,
    # bounded by the SQP wall cap)
    sim_time_s = sim_cfg.simulation_period_us * 1e-6
    max_sim_s = sim_time_s if sim_cfg.const_update_freq else max(
        sim_time_s, (sqp_cfg.max_time_us or sim_cfg.simulation_period_us) * 1e-6)
    n_sub = int(round(max_sim_s / sim_cfg.sim_step_time))

    # warm-up (REMOVE_JITTERS, mpcsim.cuh:222-242); the first call also
    # builds the kernels
    for _ in range(max(1, sim_cfg.remove_jitters)):
        solver(xu, lam, xs, ee_goal, rho)
        _sync(dev)

    stats = MPCStats([], [], [], [], [], [], [])
    stats.tracking_path.append(xs)

    shift_threshold = sim_cfg.shift_threshold_frac * timestep
    clock, shifted = np.float64(0.0), np.bool_(False)
    prev_sim_s = 0.0
    traj_offset = 0

    for step in range(sim_cfg.max_control_updates):
        if traj_offset >= traj_steps:
            break

        t0 = time.perf_counter()
        res = solver(xu, lam, xs, ee_goal, rho)
        _sync(dev)
        sqp_time_us = (time.perf_counter() - t0) * 1e6

        # stats stay on the device until the end
        stats.linsys_iters.append(res.pcg_iters)
        stats.linsys_exits.append(res.pcg_converged)
        stats.sqp_times_us.append(sqp_time_us)
        stats.sqp_iters.append(res.sqp_iters)
        stats.sqp_exits.append(res.gave_up)

        sim_time_us = (sim_cfg.simulation_period_us if sim_cfg.const_update_freq
                       else sqp_time_us)
        # adaptive mode: the plant's substep budget integrates at most
        # max_sim_s; clamp so the reported sim time is the integrated time
        if sim_time_us > max_sim_s * 1e6:
            warnings.warn(
                f"solve wall time {sim_time_us:.0f} us exceeds the plant "
                f"substep budget {max_sim_s * 1e6:.0f} us; clamping sim time")
            sim_time_us = max_sim_s * 1e6
        sim_s = sim_time_us * 1e-6
        do_shift, clock, shifted = _shift_rule(clock, shifted, sim_s, timestep,
                                               shift_threshold)
        shift = None
        if do_shift:
            traj_offset += 1
            tails = _backfill(xu_traj_t, ee_traj_t, nq,
                              torch.full((1,), traj_offset, device=dev), N)
            shift = tuple(t[0] for t in tails)
        xs, xu, lam, ee_goal, err = _control_update(
            model, res, xs, xu_old, ee_goal, prev_sim_s, sim_s, timestep, n_sub,
            sim_cfg.sim_step_time, shift)
        if err is not None:
            # tracking error before the goal shifts (mpcsim.cuh:300-309)
            stats.tracking_errors.append(err)
        xu_old, rho, prev_sim_s = res.xu, res.rho, sim_s
        stats.tracking_path.append(xs)

        if sim_cfg.live_print_path:
            # LIVE_PRINT_PATH (settings.cuh:20-26, mpcsim.cuh:256-262)
            print(" ".join(f"{v:.6f}" for v in xs.tolist()))
        if verbose and step % 200 == 0:
            print(f"step {step:5d} offset {traj_offset:4d} sqp {sqp_time_us:8.1f}us")

        # PCG health every 1000 steps (mpcsim.cuh:382-387): warn when more
        # than half of the linear solves exit on max_iter
        if step > 0 and step % 1000 == 0:
            ex = torch.stack(stats.linsys_exits).cpu().numpy()
            its = torch.stack(stats.sqp_iters).cpu().numpy()
            valid = np.arange(ex.shape[1])[None, :] < its[:, None]
            if valid.any():
                exit_rate = 100.0 * (1.0 - ex[valid].mean())
                if exit_rate > 50.0:
                    print(f"WARNING: PCG max-iter exit rate {exit_rate:.1f}% "
                          "> 50% - increase PCGConfig.max_iter or loosen "
                          "exit_tol (mpcsim.cuh:384-387)")

    stats.final_tracking_error = float(_tracking_error(model, xs, ee_goal))
    _finalize_stats(stats)
    return stats


# ---------------------------------------------------------------------------
# the closed loop as device work
# ---------------------------------------------------------------------------


def _ondevice_schedule(xu_traj, ee_traj, N, nq, timestep, period_s,
                       shift_threshold, max_updates):
    """The constant-frequency shift schedule, a deterministic function of
    (period, timestep), worked out on the host by ``_shift_rule``.  Returns
    (shift flags (steps,) list of bool, tails (steps, nx+nu), goal tails
    (steps, 6)), the backfill rows on the trajectories' device."""
    traj_steps = xu_traj.shape[0]
    clock, shifted = np.float64(0.0), np.bool_(False)
    flags, offsets, traj_offset = [], [], 0
    while traj_offset < traj_steps and len(flags) < max_updates:
        do_shift, clock, shifted = _shift_rule(clock, shifted, period_s,
                                               timestep, shift_threshold)
        flags.append(bool(do_shift))
        traj_offset += flags[-1]
        offsets.append(traj_offset)
    tails, goal_tails = _backfill(
        xu_traj, ee_traj, nq, torch.tensor(offsets, device=xu_traj.device), N)
    return flags, tails, goal_tails


def _ondevice_scan(model, solve, timestep, period_s, n_sub, sim_step, xu0,
                   lam0, xs0, ee0, rho0, shift_flags, tails, goal_tails,
                   every_err=False):
    """Constant-frequency core: per control step one solve and one
    ``_control_update`` on the host's schedule, with no read-back.  Returns
    (outs, final_err): outs holds err (n_shifts,; (steps,) with
    ``every_err``), xs (steps, nx), sqp_iters (steps,), pcg_iters (steps,
    max_iter)."""
    dev, dtype = xu0.device, xu0.dtype
    period = _kernels.scalar(period_s, dev, dtype)
    step_t = _kernels.scalar(timestep, dev, dtype)
    t_off = _kernels.scalar(0.0, dev, dtype)
    xu, xu_old, lam, xs, ee_goal, rho = xu0, xu0, lam0, xs0, ee0, rho0
    errs, xs_path, sqp_iters, pcg_iters = [], [], [], []
    for i, do_shift in enumerate(shift_flags):
        res = solve(xu, lam, xs, ee_goal, rho)
        xs, xu, lam, ee_goal, err = _control_update(
            model, res, xs, xu_old, ee_goal, t_off, period, step_t, n_sub,
            sim_step, (tails[i], goal_tails[i]) if do_shift else None,
            record=every_err)
        if err is not None:
            errs.append(err)
        xu_old, rho, t_off = res.xu, res.rho, period
        xs_path.append(xs)
        sqp_iters.append(res.sqp_iters)
        pcg_iters.append(res.pcg_iters)
    outs = dict(err=torch.stack(errs) if errs else xs0.new_zeros((0,)),
                xs=torch.stack(xs_path), sqp_iters=torch.stack(sqp_iters),
                pcg_iters=torch.stack(pcg_iters))
    return outs, _tracking_error(model, xs, ee_goal)


def _ondevice_scan_adaptive(model, solve, timestep, n_sub, sim_step,
                            shift_threshold, per_iter_s, base_s, n_steps,
                            xu0, lam0, xs0, ee0, rho0, xu_traj, ee_traj):
    """Adaptive-frequency core.  The reference advances the plant by the
    previous solve's measured wall time (mpcsim.cuh:280-288); here the solve
    time is modelled from what the device knows,
        t_solve = base_s + per_iter_s * sqp_iters,
    and the data-dependent shift schedule (``_shift_rule``), trajectory
    offset and backfill stay on the device (``torch.where`` and
    ``index_select`` with device indices).  Steps after the trajectory is
    exhausted freeze the carry and are masked by ``active`` in the
    outputs."""
    N = xu0.shape[0]
    traj_steps = xu_traj.shape[0]
    dev, dtype = xu0.device, xu0.dtype
    max_sim_s = (n_sub + 1) * sim_step
    step_t = _kernels.scalar(timestep, dev, dtype)
    zero = _kernels.scalar(0.0, dev, dtype)
    carry = (xu0, xu0, lam0, xs0, ee0, rho0, zero,
             torch.zeros((), dtype=torch.int64, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev), zero,
             torch.ones((), dtype=torch.bool, device=dev))
    keys = ("err", "shifted", "xs", "sqp_iters", "pcg_iters", "sim_time", "active")
    outs = {k: [] for k in keys}
    for _ in range(n_steps):
        (xu, xu_old, lam, xs, ee_goal, rho, clock, traj_offset, shifted,
         prev_sim, active) = carry
        res = solve(xu, lam, xs, ee_goal, rho)
        sim_time = torch.clamp(base_s + per_iter_s * res.sqp_iters.to(dtype),
                               0.0, max_sim_s)
        do_shift, clock, shifted = _shift_rule(clock, shifted, sim_time,
                                               timestep, shift_threshold)
        do_shift = do_shift & active
        traj_offset = traj_offset + do_shift.to(torch.int64)
        tails = _backfill(xu_traj, ee_traj, model.nq, traj_offset.reshape(1), N)
        xs_n, xu_n, lam_n, ee_n, err = _control_update(
            model, res, xs, xu_old, ee_goal, prev_sim, sim_time, step_t, n_sub,
            sim_step, tuple(t[0] for t in tails), when=do_shift)
        new = (xu_n, res.xu, lam_n, xs_n, ee_n, res.rho, clock, traj_offset,
               shifted, sim_time, active & (traj_offset < traj_steps))
        # freeze the whole carry once the trajectory is exhausted
        carry = tuple(torch.where(active, a, b) for a, b in zip(new, carry))
        for k, v in zip(keys, (err, do_shift, xs_n, res.sqp_iters,
                               res.pcg_iters, sim_time, active)):
            outs[k].append(v)
    outs = {k: torch.stack(v) for k, v in outs.items()}
    return outs, _tracking_error(model, carry[3], carry[4])


def simulate_mpc_ondevice(
    model: RobotModel,
    xu_traj: np.ndarray,
    eepos_traj: np.ndarray,
    knot_points: int,
    timestep: float,
    cost: Optional[CostConfig] = None,
    sqp_cfg: SQPConfig = SQPConfig(max_iter=2),
    pcg_cfg: Optional[PCGConfig] = None,
    sim_cfg: SimConfig = SimConfig(),
    linsys: str = "auto",
    dtype=None,
    per_iter_us: Optional[float] = None,
    base_us: float = 0.0,
    knot_mesh=None,
    pcg_method: str = "pipelined",
    **route,
):
    """The whole closed-loop tracking run as device work with no read-back
    per control step (the SQP loop's own stop flag aside when
    ``sqp_cfg.max_iter > 1``).

    Constant-frequency mode (CONST_UPDATE_FREQ, settings.cuh:56): the shift
    schedule is a deterministic function of (period, timestep), precomputed
    on the host.  Adaptive-frequency mode (const_update_freq=False,
    mpcsim.cuh:280-288): the solve time is modelled as base_us + per_iter_us
    * sqp_iters (per_iter_us from ``calibrate_sqp_iteration_us`` when not
    given) and the shift schedule becomes data-dependent on the device.
    Computes on the model's device; ``linsys`` (the direct solvers
    included; ``"qdldl_host"`` reads back every SQP iteration by design) and
    ``route`` as in ``simulate_mpc``.

    ``knot_mesh`` (a ``parallel.KnotMesh``, or a ``DistKnotMesh`` with every
    process running the loop): every solve runs knot-sharded,
    ``sqp_solve_sharded`` with ``pcg_method`` and ``route``'s ``fused``
    (default "auto": the slab kernels on the card); ``linsys`` is then not
    read.  Adaptive mode with a mesh needs an explicit ``per_iter_us``
    (the calibration times the single-device solver).

    Returns a dict: tracking_errors (n_shifts,), xs_path (steps, nx),
    sqp_iters (steps,), pcg_iters (steps, max_iter), final_tracking_error
    (), control_updates; adaptive mode adds sim_times_us (steps,) and
    per_iter_us.
    """
    if knot_mesh is not None and not sim_cfg.const_update_freq \
            and per_iter_us is None:
        raise ValueError("adaptive mode with knot_mesh requires an explicit "
                         "per_iter_us (calibrate the sharded solver once)")
    N = knot_points
    nq = model.nq
    nx = 2 * nq
    dev = model.xc.device
    dtype = model.dtype if dtype is None else dtype
    traj_steps = xu_traj.shape[0]
    cost = cost or CostConfig.for_knots(N)
    pcg_cfg = pcg_cfg or PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)
    linsys = _resolve_linsys(linsys, dev)

    period_s = sim_cfg.simulation_period_us * 1e-6
    shift_threshold = sim_cfg.shift_threshold_frac * timestep
    xu_traj_t = torch.tensor(xu_traj, dtype=dtype, device=dev)
    ee_traj_t = torch.tensor(eepos_traj, dtype=dtype, device=dev)
    xu0, ee0 = xu_traj_t[:N], ee_traj_t[:N]
    xs0 = xu0[0, :nx]
    lam0 = torch.zeros((N, nx), dtype=dtype, device=dev)
    rho0 = _kernels.scalar(1e-3, dev, dtype)
    if knot_mesh is not None:
        solve = make_sharded_sqp_solver(model, cost, sqp_cfg, pcg_cfg, timestep,
                                        knot_mesh, pcg_method=pcg_method,
                                        **route)
    else:
        solve = make_sqp_solver(model, cost, sqp_cfg, pcg_cfg, timestep,
                                linsys=linsys, **route)

    if not sim_cfg.const_update_freq:
        if per_iter_us is None:
            per_iter_us = calibrate_sqp_iteration_us(
                model, cost, sqp_cfg, pcg_cfg, timestep, linsys,
                xu0, lam0, xs0, ee0, rho0, **route)
        # plant substeps must cover the largest modelled solve
        max_solve_s = (base_us + per_iter_us * sqp_cfg.max_iter) * 1e-6
        n_sub_a = max(1, int(math.ceil(max_solve_s / sim_cfg.sim_step_time)))
        min_solve_s = max((base_us + per_iter_us) * 1e-6, 1e-9)
        n_steps = min(sim_cfg.max_control_updates,
                      int(math.ceil(traj_steps * timestep / min_solve_s)) + 8)
        outs, final_err = _ondevice_scan_adaptive(
            model, solve, timestep, n_sub_a, sim_cfg.sim_step_time,
            shift_threshold, float(per_iter_us) * 1e-6, float(base_us) * 1e-6,
            n_steps, xu0, lam0, xs0, ee0, rho0, xu_traj_t, ee_traj_t)
        active = outs["active"]
        return dict(
            tracking_errors=outs["err"][outs["shifted"]],
            xs_path=outs["xs"][active],
            sqp_iters=outs["sqp_iters"][active],
            pcg_iters=outs["pcg_iters"][active],
            sim_times_us=outs["sim_time"][active] * 1e6,
            final_tracking_error=final_err,
            control_updates=int(active.sum()),
            per_iter_us=float(per_iter_us),
        )

    shift_flags, tails, goal_tails = _ondevice_schedule(
        xu_traj_t, ee_traj_t, N, nq, timestep, period_s, shift_threshold,
        sim_cfg.max_control_updates)
    outs, final_err = _ondevice_scan(
        model, solve, timestep, period_s, int(period_s / sim_cfg.sim_step_time),
        sim_cfg.sim_step_time, xu0, lam0, xs0, ee0, rho0, shift_flags, tails,
        goal_tails)
    return dict(
        tracking_errors=outs["err"],
        xs_path=outs["xs"],
        sqp_iters=outs["sqp_iters"],
        pcg_iters=outs["pcg_iters"],
        final_tracking_error=final_err,
        control_updates=len(shift_flags),
    )


# ---------------------------------------------------------------------------
# B closed loops at once
# ---------------------------------------------------------------------------


def _ondevice_scan_batched_fused(model, cost, sqp_cfg, pcg_cfg, timestep,
                                 period_s, n_sub, sim_step, xu0_b, lam0_b,
                                 xs0_b, ee0_b, rho0_b, shift_flags, tails,
                                 goal_tails):
    """B closed loops on the instance-grid kernels: per control update one
    batched solve (``sqp_solve_batched_fused``: K8a-c, K3b), one K4b launch
    under every instance's previous plan, every instance's tracking error,
    the shared shift where the schedule says, and the measured states
    pinned; nothing is read back beyond the solve's stop flag.  Returns
    (outs, final_err) in the JAX scan's layout: err (B, steps), xs (B,
    steps, nx), sqp_iters (B, steps), pcg_iters (B, steps, max_iter);
    final_err (B,)."""
    dev, dtype = xu0_b.device, xu0_b.dtype
    period = _kernels.scalar(period_s, dev, dtype)
    step_t = _kernels.scalar(timestep, dev, dtype)
    t_off = _kernels.scalar(0.0, dev, dtype)
    xu, xu_old, lam, xs, ee_goal, rho = xu0_b, xu0_b, lam0_b, xs0_b, ee0_b, rho0_b
    keys = ("err", "xs", "sqp_iters", "pcg_iters")
    outs = {k: [] for k in keys}
    for i, do_shift in enumerate(shift_flags):
        res = sqp_solve_batched_fused(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs,
                                      ee_goal, rho, timestep)
        xs = simulate_plant_batched(model, xs, xu_old, t_off, period, step_t,
                                    n_sub, sim_step)
        err = _tracking_error(model, xs, ee_goal)
        xu, lam = res.xu, res.lam
        if do_shift:
            xu, lam, ee_goal = _shift_all(xu, lam, ee_goal, tails[i], goal_tails[i])
        xu = _pin_state(xu, xs)
        xu_old, rho, t_off = res.xu, res.rho, period
        for k, v in zip(keys, (err, xs, res.sqp_iters, res.pcg_iters)):
            outs[k].append(v)
    outs = {k: torch.stack(v, 1) for k, v in outs.items()}
    return outs, _tracking_error(model, xs, ee_goal)


def _ondevice_run_batched(model, cost, sqp_cfg, pcg_cfg, linsys, timestep,
                          period_s, n_sub, sim_step, xu0, ee0, xs0_b,
                          shift_flags, tails, goal_tails):
    """B closed loops from the starts xs0_b (B, nx), each from the first
    window xu0 (N, nx+nu), ee0 (N, 6) with its start pinned, lam = 0 and
    rho = 1e-3, on the shared schedule (``_ondevice_schedule``).  On CUDA
    tensors with ee cost, the stair preconditioner and linsys "pcg" or
    "pcg_cuda", the instance-grid scan (``_ondevice_scan_batched_fused``);
    otherwise ``_ondevice_scan`` per instance with the unfused solve, the
    counterpart of the JAX package's vmap.  Returns (outs, final_err) as
    ``_ondevice_scan_batched_fused``, outs with the shared shift mask
    ``shifted`` (steps,)."""
    B, nx = xs0_b.shape
    dev, dtype = xu0.device, xu0.dtype
    shifted = torch.tensor(shift_flags, dtype=torch.bool, device=dev)
    xu0_b = _pin_state(xu0.expand(B, *xu0.shape), xs0_b)
    lam0_b = xu0.new_zeros((B, xu0.shape[0], nx))
    ee0_b = ee0.expand(B, *ee0.shape).contiguous()
    rho0_b = torch.full((B,), 1e-3, dtype=dtype, device=dev)
    if (dev.type == "cuda" and cost.mode == "ee"
            and pcg_cfg.preconditioner == "stair" and linsys in ("pcg", "pcg_cuda")):
        outs, final_err = _ondevice_scan_batched_fused(
            model, cost, sqp_cfg, pcg_cfg, timestep, period_s, n_sub, sim_step,
            xu0_b, lam0_b, xs0_b, ee0_b, rho0_b, shift_flags, tails, goal_tails)
    else:
        solve = make_sqp_solver(model, cost, sqp_cfg, pcg_cfg, timestep,
                                linsys=linsys, fused=False)
        runs = [_ondevice_scan(model, solve, timestep, period_s, n_sub, sim_step,
                               xu0_b[i], lam0_b[i], xs0_b[i], ee0_b[i], rho0_b[i],
                               shift_flags, tails, goal_tails, every_err=True)
                for i in range(B)]
        outs = {k: torch.stack([o[k] for o, _ in runs]) for k in runs[0][0]}
        final_err = torch.stack([fe for _, fe in runs])
    outs["shifted"] = shifted
    return outs, final_err


def simulate_mpc_ondevice_batched(
    model: RobotModel,
    xu_traj: np.ndarray,
    eepos_traj: np.ndarray,
    knot_points: int,
    timestep: float,
    batch: int,
    perturb_scale: float = 0.05,
    seed: int = 0,
    cost: Optional[CostConfig] = None,
    sqp_cfg: SQPConfig = SQPConfig(max_iter=2),
    pcg_cfg: Optional[PCGConfig] = None,
    sim_cfg: SimConfig = SimConfig(),
    linsys: str = "auto",
    dtype=None,
    instance_mesh=None,
):
    """Scenario-parallel closed-loop MPC: ``batch`` tracking runs from
    perturbed starts as device work, on the shared constant-frequency shift
    schedule.  The starts are the trajectory's first state plus
    ``perturb_scale`` times standard normals drawn from a ``torch.Generator``
    seeded with ``seed`` on the model's device; these are not the JAX
    package's ``jax.random`` draws for the same seed.  On the card (ee cost,
    stair preconditioner, linsys "pcg" / "pcg_cuda" or "auto") every update
    solves all instances through the instance-grid kernels and rolls their
    plants in one K4b launch; otherwise each instance runs the unfused
    on-device loop.  ``instance_mesh`` (``make_mesh(n_instance)`` or
    ``make_host_aligned_mesh``): each instance group held here runs that
    loop on its slab of batch / n_instance starts, with no collective (the
    JAX package's shard_map over the instance axis): on one device the
    groups one after another, across processes each process its own group
    on its own card, at the same time as the others.  The starts are drawn
    for the whole batch first, so an instance's run does not depend on the
    mesh.

    Returns a dict: tracking_errors (batch, steps), shift_mask (steps,) (the
    shared schedule), final_tracking_error (batch,), control_updates; with
    an instance mesh, the rows of the instances held here (all of them on
    one device).
    """
    if not sim_cfg.const_update_freq:
        raise ValueError("on-device sim supports const_update_freq mode only")
    if instance_mesh is not None and batch % instance_mesh.shape["instance"]:
        raise ValueError(f"batch {batch} not divisible by "
                         f"{instance_mesh.shape['instance']} instance devices")
    N = knot_points
    nq = model.nq
    nx = 2 * nq
    dev = model.xc.device
    dtype = model.dtype if dtype is None else dtype
    cost = cost or CostConfig.for_knots(N)
    pcg_cfg = pcg_cfg or PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)
    linsys = _resolve_linsys(linsys, dev)
    period_s = sim_cfg.simulation_period_us * 1e-6
    shift_threshold = sim_cfg.shift_threshold_frac * timestep
    xu_traj_t = torch.tensor(xu_traj, dtype=dtype, device=dev)
    ee_traj_t = torch.tensor(eepos_traj, dtype=dtype, device=dev)
    shift_flags, tails, goal_tails = _ondevice_schedule(
        xu_traj_t, ee_traj_t, N, nq, timestep, period_s, shift_threshold,
        sim_cfg.max_control_updates)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dx0 = perturb_scale * torch.randn((batch, nx), generator=gen, dtype=dtype,
                                      device=dev)
    xs0_b = xu_traj_t[0, :nx] + dx0
    groups = ([slice(0, batch)] if instance_mesh is None
              else instance_mesh.instance_slices(batch))
    runs = [_ondevice_run_batched(
        model, cost, sqp_cfg, pcg_cfg, linsys, timestep, period_s,
        int(period_s / sim_cfg.sim_step_time), sim_cfg.sim_step_time,
        xu_traj_t[:N], ee_traj_t[:N], xs0_b[g], shift_flags, tails, goal_tails)
        for g in groups]
    return dict(tracking_errors=torch.cat([o["err"] for o, _ in runs]),
                shift_mask=runs[0][0]["shifted"],
                final_tracking_error=torch.cat([fe for _, fe in runs]),
                control_updates=len(shift_flags))


# ---------------------------------------------------------------------------
# the warm-started chain (bench.py's timed body)
# ---------------------------------------------------------------------------


class ChainResult(NamedTuple):
    xu: torch.Tensor           # (N, nx+nu) plan after the last shift
    lam: torch.Tensor          # (N, nx)
    xs: torch.Tensor           # (nx,)
    ee_goal: torch.Tensor      # (N, 6) goal window after the last shift
    rho: torch.Tensor          # ()
    step_xu: torch.Tensor      # (steps, N, nx+nu) each step's solved plan
    merit: torch.Tensor        # (steps,) each step's final merit
    pcg_iters: torch.Tensor    # (steps,) PCG iterations of each step's first SQP iteration
    ls_alpha_idx: torch.Tensor  # (steps,) line-search choice of each step's first iteration


def run_chain(model: RobotModel, cost: CostConfig, sqp_cfg: SQPConfig,
              pcg_cfg: PCGConfig, xu, lam, xs, ee_full, rho, dt: float,
              steps: int, linsys: str = "pcg_cuda",
              integrator_type: int = 0, **route) -> ChainResult:
    """``steps`` warm-started control steps, as ``bench.py``'s chain: one SQP
    solve, then the shift of plan, multipliers and goal window by one knot,
    with the next measured state taken from the plan (xs = xu[1, :nx]).
    ee_full (L, 6) is the whole recorded goal trace: the window is its first
    N rows, and step i appends row (i + N) mod L after the shift.  Nothing
    is read back to the host."""
    N = xu.shape[0]
    nx = lam.shape[-1]
    ee = ee_full[:N]
    step_xu, merits, iters, alpha_idx = [], [], [], []
    for i in range(steps):
        res = sqp_solve(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee, rho, dt,
                        linsys=linsys, integrator_type=integrator_type, **route)
        step_xu.append(res.xu)
        merits.append(res.merit)
        iters.append(res.pcg_iters[0])
        alpha_idx.append(res.ls_alpha_idx[0])
        xs = res.xu[1, :nx]
        xu, lam, ee = _shift_all(res.xu, res.lam, ee, res.xu[-1],
                                 ee_full[(i + N) % ee_full.shape[0]])
        rho = res.rho
    return ChainResult(xu=xu, lam=lam, xs=xs, ee_goal=ee, rho=rho,
                       step_xu=torch.stack(step_xu), merit=torch.stack(merits),
                       pcg_iters=torch.stack(iters),
                       ls_alpha_idx=torch.stack(alpha_idx))
