"""RobotModel: a serial-chain rigid-body model held as tensors.

Port of ``mpcgpu_tpu/models/robot.py``.  The per-joint transforms are stored
as their affine decomposition in (sin q, cos q):

    X_k(q)    = xc[k] + sin(q_k) * xs[k] + cos(q_k) * xcos[k]      (6x6 motion)
    Xhom_k(q) = hc[k] + sin(q_k) * hs[k] + cos(q_k) * hcos[k]      (4x4 homogeneous)

Joints are revolute about the local z axis and joint k's parent is k-1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_FIELDS = ("xc", "xs", "xcos", "inertia", "hc", "hs", "hcos")


@dataclasses.dataclass(eq=False)
class RobotModel:
    xc: torch.Tensor        # (nq, 6, 6)
    xs: torch.Tensor        # (nq, 6, 6)
    xcos: torch.Tensor      # (nq, 6, 6)
    inertia: torch.Tensor   # (nq, 6, 6) spatial inertias
    hc: torch.Tensor        # (nq, 4, 4)
    hs: torch.Tensor        # (nq, 4, 4)
    hcos: torch.Tensor      # (nq, 4, 4)
    # base gravitational acceleration; enters RNEA/ABA as the base spatial
    # acceleration [0, 0, 0, 0, 0, g]
    gravity: float = 0.0
    _packed: torch.Tensor | None = dataclasses.field(
        default=None, init=False, repr=False)

    @property
    def nq(self) -> int:
        return self.xc.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.xc.dtype

    def to(self, device=None, dtype=None) -> "RobotModel":
        return RobotModel(
            *(getattr(self, f).to(device=device, dtype=dtype) for f in _FIELDS),
            gravity=self.gravity)

    @staticmethod
    def from_numpy(obj, device="cuda", dtype=torch.float64,
                   gravity: float | None = None) -> "RobotModel":
        """Carry a model across from anything holding the seven arrays:
        an object with those attributes (a JAX ``RobotModel``) or a dict.
        The model lands on the card unless ``device`` names another."""
        get = obj.get if isinstance(obj, dict) else (
            lambda name, default=None: getattr(obj, name, default))
        arrays = [torch.tensor(np.asarray(get(f)), dtype=dtype, device=device)
                  for f in _FIELDS]
        g = float(get("gravity", 0.0) if gravity is None else gravity)
        return RobotModel(*arrays, gravity=g)

    def packed(self) -> torch.Tensor:
        """The seven arrays flattened into one contiguous vector
        [xc, xs, xcos, inertia, hc, hs, hcos] — the layout the CUDA kernels
        read their model from (csrc/common.cuh).  Built once per model."""
        if self._packed is None:
            self._packed = torch.cat(
                [getattr(self, f).reshape(-1) for f in _FIELDS])
        return self._packed

    def xmats(self, q: torch.Tensor) -> torch.Tensor:
        """Per-joint motion transforms, q (..., nq) -> (..., nq, 6, 6)."""
        s = torch.sin(q)[..., None, None]
        c = torch.cos(q)[..., None, None]
        return self.xc + s * self.xs + c * self.xcos

    def hom_xmats(self, q: torch.Tensor) -> torch.Tensor:
        """Per-joint homogeneous transforms, q (..., nq) -> (..., nq, 4, 4)."""
        s = torch.sin(q)[..., None, None]
        c = torch.cos(q)[..., None, None]
        return self.hc + s * self.hs + c * self.hcos
