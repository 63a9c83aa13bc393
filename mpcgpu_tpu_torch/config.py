"""Solver configuration and trajectory fixtures, shared with the JAX package.

``mpcgpu_tpu/config.py`` (CostConfig, PCGConfig, SQPConfig) and
``mpcgpu_tpu/utils/trajfiles.py`` are numpy-only.  They are loaded here by
file path, so the port runs on the same knobs and fixtures without
importing jax or the ``mpcgpu_tpu`` package.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_REFERENCE = Path(__file__).resolve().parents[1] / "mpcgpu_tpu"


def load_reference_file(relpath: str, name: str):
    """Execute one numpy-only file of the JAX package as module ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, _REFERENCE / relpath)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # dataclasses look their module up here
    spec.loader.exec_module(mod)
    return mod


_config = load_reference_file("config.py", "mpcgpu_tpu_torch._ref_config")
_trajfiles = load_reference_file("utils/trajfiles.py",
                                 "mpcgpu_tpu_torch._ref_trajfiles")

CostConfig = _config.CostConfig
PCGConfig = _config.PCGConfig
SQPConfig = _config.SQPConfig
load_xu_traj = _trajfiles.load_xu_traj
load_eepos_traj = _trajfiles.load_eepos_traj
