"""Robot models and batched rigid-body dynamics (port of mpcgpu_tpu.models)."""

from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.models.iiwa14 import iiwa14
from mpcgpu_tpu_torch.models import dynamics

__all__ = ["RobotModel", "iiwa14", "dynamics"]
