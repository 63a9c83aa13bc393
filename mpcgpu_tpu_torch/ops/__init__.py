"""Small-matrix, block-tridiagonal, PCG and direct-solver ops (port of
mpcgpu_tpu.ops)."""

from mpcgpu_tpu_torch.ops.btd import btd_matvec, btd_to_dense
from mpcgpu_tpu_torch.ops.schur import SchurSystem, form_schur_system, compute_dz
from mpcgpu_tpu_torch.ops.pcg import pcg_solve
from mpcgpu_tpu_torch.ops.ldl import btd_ldl_solve

__all__ = ["btd_matvec", "btd_to_dense", "SchurSystem", "form_schur_system",
           "compute_dz", "pcg_solve", "btd_ldl_solve"]
