"""KKT assembly, merit, the K1/K3 kernels and the SQP loop (port of mpcgpu_tpu.solver)."""
