"""Robot models and batched rigid-body dynamics (port of mpcgpu_tpu.models):
the IIWA-14, any revolute-z serial chain (``chain``) and URDF loading
(``urdf``)."""

from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.models.iiwa14 import iiwa14
from mpcgpu_tpu_torch.models.chain import (make_serial_chain, planar_arm,
                                           spatial_inertia)
from mpcgpu_tpu_torch.models.urdf import load_urdf
from mpcgpu_tpu_torch.models import dynamics

__all__ = ["RobotModel", "iiwa14", "dynamics", "load_urdf",
           "make_serial_chain", "planar_arm", "spatial_inertia"]
