"""Kuka IIWA-14 model (7 revolute-z joints, serial chain)."""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch.models import _iiwa14_data as _d
from mpcgpu_tpu_torch.models.robot import RobotModel


def iiwa14(dtype=torch.float32, device="cuda", gravity: float = 0.0) -> RobotModel:
    """Build the IIWA-14 model (gravity=0 matches the reference plant) on
    ``device``: the card unless the caller asks for the CPU."""
    return RobotModel.from_numpy(
        dict(xc=_d.XC, xs=_d.XS, xcos=_d.XCOS, inertia=_d.IMATS,
             hc=_d.HOMC, hs=_d.HOMS, hcos=_d.HOMCOS),
        device=device, dtype=dtype, gravity=gravity)
