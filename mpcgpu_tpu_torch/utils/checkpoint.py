"""Checkpoint/resume for MPC sessions.

The reference has no checkpointing (SURVEY.md section 5) — its closest
analogue is the warm-start state carried across control steps.  For
production deployment this framework persists exactly that warm-start state
(plan, multipliers, rho, goal window, plant state, time bookkeeping) so a
controller can resume mid-trajectory.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np


def save_mpc_state(path, **state: Any) -> None:
    """Save named arrays/scalars (xu, lam, rho, xs, ee_goal, traj_offset, ...)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in state.items()})


def load_mpc_state(path) -> Dict[str, np.ndarray]:
    with np.load(Path(path), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
