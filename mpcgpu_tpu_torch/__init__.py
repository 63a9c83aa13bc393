"""mpcgpu_tpu_torch — the PyTorch/CUDA port of the nonlinear MPC solver.

The JAX package ``mpcgpu_tpu`` is the reference; this package computes the
same things with PyTorch tensors and, on an NVIDIA Hopper card, with
hand-written CUDA kernels (``csrc/``, built by ``_kernels.py``).  It imports
nothing of the JAX package and keeps its own copies of the configuration,
the model constants and the numpy-only utilities:

  * ``config.py`` CostConfig, PCGConfig, SQPConfig, SimConfig;
  * ``models/``  robot model (the IIWA-14, any revolute-z serial chain,
                 URDF loading and export), spatial algebra, batched
                 rigid-body dynamics;
  * ``ops/``     small-matrix Gauss-Jordan, block-tridiagonal algebra, Schur
                 condensation, PCG, the direct solvers (block LDL^T, PCR, the
                 CSC packing), the PCG kernels K2 (PCG + dz), K2' (PCG) and
                 K6 (dz), and the PCR kernel K7;
  * ``native/``  the host's sparse and block LDL^T (C++ through ctypes);
  * ``solver/``  KKT assembly, the l1 merit, the KKT kernels K1 (+ Schur) and
                 K5 (blocks), the line-search kernel K3 and the SQP loop;
  * ``parallel/`` the batched SQP solve and its instance-grid kernels K8;
  * ``sim/``     the closed-loop simulators (one loop, B loops at once), the
                 plant kernels K4 / K4b and the warm-started chain;
  * ``utils/``   trajectory fixtures, experiment statistics, checkpoints;
  * ``track_iiwa_pcg.py``, ``track_iiwa_qdldl.py`` the closed-loop tracker
                 scripts (PCG, direct solvers); ``track_chain.py`` the
                 tracker of any serial chain or URDF.

Public functions keep the JAX package's knot-leading layouts.  Entry points
build on the card unless the caller asks for the CPU, and every function
computes where its input tensors live.  A kernel wrapper given CPU tensors
runs its plain PyTorch version; given CUDA tensors it launches its kernel or
raises.
"""

import torch

from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SimConfig, SQPConfig

# Full f32 contractions: TF32 matmuls broke CG on this problem in the
# reference (mpcgpu_tpu/precision.py forces the same on the TPU).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def __getattr__(name):
    # the JAX package's top-level conveniences, loaded on first use
    if name in ("sqp_solve", "make_sqp_solver"):
        from mpcgpu_tpu_torch.solver import sqp
        return getattr(sqp, name)
    if name in ("simulate_mpc", "simulate_mpc_ondevice",
                "simulate_mpc_ondevice_batched"):
        from mpcgpu_tpu_torch.sim import mpc
        return getattr(mpc, name)
    if name == "iiwa14":
        from mpcgpu_tpu_torch.models import iiwa14
        return iiwa14
    raise AttributeError(name)


__all__ = ["CostConfig", "PCGConfig", "SimConfig", "SQPConfig", "sqp_solve",
           "make_sqp_solver", "simulate_mpc", "simulate_mpc_ondevice",
           "simulate_mpc_ondevice_batched", "iiwa14"]
