"""Loaders for the recorded trajectory fixtures.

File formats (readCSVToVecVec, include/utils/experiment.cuh:144-170):
  * ``{s}_{g}_traj.csv``: rows of 21 = 14 state + 7 control per knot;
  * ``{s}_{g}_eepos.traj``: rows of 6 = ee [xyz, rpy] goal per knot.

Search order: ``$MPCGPU_TPU_TRAJDIR`` when set (authoritative: a missing file
there is an error), else the repository's ``data/trajfiles/``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_LOCAL_DIR = Path(__file__).resolve().parents[2] / "data" / "trajfiles"


def trajfile_dir() -> Path:
    env = os.environ.get("MPCGPU_TPU_TRAJDIR")
    return Path(env) if env else _LOCAL_DIR


def _find(fname: str) -> Path:
    p = trajfile_dir() / fname
    if not p.is_file():
        hint = ("; $MPCGPU_TPU_TRAJDIR is set and treated as authoritative"
                if os.environ.get("MPCGPU_TPU_TRAJDIR") else "")
        raise FileNotFoundError(f"{p} not found{hint}")
    return p


def load_xu_traj(name: str = "0_0", dtype=np.float64) -> np.ndarray:
    """(steps, 21) state+control trace."""
    return np.loadtxt(_find(f"{name}_traj.csv"), delimiter=",", dtype=dtype)


def load_eepos_traj(name: str = "0_0", dtype=np.float64) -> np.ndarray:
    """(steps, 6) end-effector goal trace [xyz, rpy]."""
    return np.loadtxt(_find(f"{name}_eepos.traj"), delimiter=",", dtype=dtype)
