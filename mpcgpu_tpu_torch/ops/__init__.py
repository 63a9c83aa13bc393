"""Small-matrix, block-tridiagonal and PCG ops (port of mpcgpu_tpu.ops)."""
