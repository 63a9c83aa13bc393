"""The one traffic generator: a recorded trace, the control loop's schedule
over it, and the starts of its episodes.

A traffic mix is a JSON file ``portbench/traffic/<name>.json``:

    {"trace": "0_0", "rows": [first, end or null], "start_sigma": 0.01,
     "why": "..."}

An episode tracks the trace's rows [first, end) closed loop from the rows'
first state plus ``start_sigma`` times standard normals (one draw per
instance), with the first N rows as the first plan and goal window.  The
controller runs at a constant frequency (the reference's
CONST_UPDATE_FREQ, settings.cuh:56-72): every update advances the
simulated clock by one control period, and the plan, multipliers and goal
window shift one knot at the first update of each trajectory timestep
whose clock passes the threshold (mpcsim.cuh:296-330).  The schedule is a
function of (period, timestep, rows) alone, so every episode of a mix, and
every seed, does the same work; the seed moves only the starts.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


class Schedule(NamedTuple):
    xu_rows: torch.Tensor     # (R, nx + nu) the trace's rows
    ee_rows: torch.Tensor     # (R, 6) the goal trace's rows
    shift: list               # (U,) bool: this update shifts
    tails: torch.Tensor       # (U, nx + nu) the plan row a shift appends
    goal_tails: torch.Tensor  # (U, 6) the goal row a shift appends


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def trace_rows(mix: dict):
    """(xu (R, 21), ee (R, 6)) float64 numpy rows of the mix's trace."""
    first, end = mix["rows"]
    xu = np.loadtxt(HERE / "traces" / f"{mix['trace']}_traj.csv", delimiter=",")
    ee = np.loadtxt(HERE / "traces" / f"{mix['trace']}_eepos.traj", delimiter=",")
    return xu[first:end], ee[first:end]


def _shift_rule(clock, shifted, sim_time, timestep, threshold):
    clock = clock + sim_time
    do_shift = (not shifted) and clock > threshold
    wrap = clock > timestep
    shifted = (shifted or do_shift) and not wrap
    if wrap:
        clock = np.remainder(clock, timestep)
    return do_shift, clock, shifted


def schedule(mix: dict, knots: int, nq: int, timestep: float, period_s: float,
             threshold_frac: float, device, dtype=torch.float32) -> Schedule:
    """The episode's updates until the trajectory offset passes the rows'
    end.  A shift appends the rows at the horizon's end index (offset +
    N - 1), or past the trace's end its last joint positions with zero
    velocities and controls and its last goal."""
    xu_np, ee_np = trace_rows(mix)
    steps = xu_np.shape[0]
    clock, shifted, offset = np.float64(0.0), False, 0
    flags, offsets = [], []
    while offset < steps:
        do_shift, clock, shifted = _shift_rule(clock, shifted, period_s, timestep,
                                               threshold_frac * timestep)
        flags.append(bool(do_shift))
        offset += flags[-1]
        offsets.append(offset)
    xu = torch.tensor(xu_np, dtype=dtype, device=device)
    ee = torch.tensor(ee_np, dtype=dtype, device=device)
    off = torch.tensor(offsets, device=device)
    idx = torch.clamp(off + knots - 1, max=steps - 1)
    rest = torch.zeros_like(xu[-1])
    rest[:nq] = xu[-1, :nq]
    tails = torch.where((off + knots < steps)[:, None], xu.index_select(0, idx), rest)
    return Schedule(xu, ee, flags, tails, ee.index_select(0, idx))


def starts(gen: torch.Generator, sched: Schedule, batch: int, nx: int,
           sigma: float):
    """One episode's measured start states (batch, nx): the rows' first
    state plus sigma N(0, 1), drawn from ``gen`` on its device."""
    base = sched.xu_rows[0, :nx]
    noise = torch.randn((batch, nx), generator=gen, device=base.device,
                        dtype=base.dtype)
    return base + sigma * noise
