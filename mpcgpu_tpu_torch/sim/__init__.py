"""The closed-loop MPC simulator, the plant kernel K4 and the warm-started
chain (port of mpcgpu_tpu.sim)."""
