"""Warm-started MPC chain (port of mpcgpu_tpu.sim)."""
