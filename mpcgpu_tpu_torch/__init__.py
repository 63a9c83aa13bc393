"""mpcgpu_tpu_torch — the PyTorch/CUDA port of the nonlinear MPC solver.

The JAX package ``mpcgpu_tpu`` is the reference; this package computes the
same things with PyTorch tensors and, on an NVIDIA Hopper card, with
hand-written CUDA kernels (``csrc/``, built by ``_kernels.py``):

  * ``models/``  robot model, spatial algebra, batched rigid-body dynamics;
  * ``ops/``     small-matrix Gauss-Jordan, block-tridiagonal algebra, Schur
                 condensation, PCG, and the PCG+dz kernel (K2);
  * ``solver/``  KKT assembly, the l1 merit, the KKT+Schur kernel (K1), the
                 line-search kernel (K3) and the SQP loop;
  * ``sim/``     the warm-started MPC chain.

Public functions keep the JAX package's knot-leading layouts.  Devices are
explicit: every function computes where its input tensors live.  A kernel
wrapper given CPU tensors runs its plain PyTorch version; given CUDA tensors
it launches its kernel or raises.
"""

import torch

from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig

# Full f32 contractions: TF32 matmuls broke CG on this problem in the
# reference (mpcgpu_tpu/precision.py forces the same on the TPU).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["CostConfig", "PCGConfig", "SQPConfig"]
