"""The closed-loop MPC simulator, the plant kernel K4 and the warm-started
chain (port of mpcgpu_tpu.sim)."""

from mpcgpu_tpu_torch.sim.mpc import MPCStats, simulate_mpc

__all__ = ["MPCStats", "simulate_mpc"]
