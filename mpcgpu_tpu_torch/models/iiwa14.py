"""Kuka IIWA-14 model (7 revolute-z joints, serial chain).

The constants are the JAX package's ``mpcgpu_tpu/models/_iiwa14_data.py``,
loaded by file path: importing ``mpcgpu_tpu.models`` would import jax.
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch.config import load_reference_file
from mpcgpu_tpu_torch.models.robot import RobotModel

_d = load_reference_file("models/_iiwa14_data.py",
                         "mpcgpu_tpu_torch._ref_iiwa14_data")

def iiwa14(dtype=torch.float32, device=None, gravity: float = 0.0) -> RobotModel:
    """Build the IIWA-14 model (gravity=0 matches the reference plant)."""
    return RobotModel.from_numpy(
        dict(xc=_d.XC, xs=_d.XS, xcos=_d.XCOS, inertia=_d.IMATS,
             hc=_d.HOMC, hs=_d.HOMS, hcos=_d.HOMCOS),
        device=device, dtype=dtype, gravity=gravity)
