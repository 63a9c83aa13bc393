"""Small-matrix, block-tridiagonal, PCG and direct-solver ops (port of
mpcgpu_tpu.ops)."""
