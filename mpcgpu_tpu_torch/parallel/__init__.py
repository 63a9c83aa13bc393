"""Batched instances (port of mpcgpu_tpu.parallel's single-device batching):
the instance-grid kernels K8 and the batched SQP solvers."""

from mpcgpu_tpu_torch.parallel.batched import make_batched_sqp_solver
from mpcgpu_tpu_torch.parallel.batched_cuda import (build_kkt_schur_batched,
                                                    compute_dz_batched,
                                                    line_search_merits_batched,
                                                    make_batched_fused_solver,
                                                    pcg_solve_batched,
                                                    sqp_solve_batched_fused)

__all__ = ["build_kkt_schur_batched", "compute_dz_batched",
           "line_search_merits_batched", "make_batched_fused_solver",
           "make_batched_sqp_solver", "pcg_solve_batched",
           "sqp_solve_batched_fused"]
