"""Batched instances and the knot-sharded path (port of
mpcgpu_tpu.parallel): the instance-grid kernels K8 and the batched SQP
solvers, also over the instance axis of a mesh; the (instance, knot) meshes
(one device, or one shard per process), the knot-sharded PCG and SQP and
their slab kernels K9a-c, K10a, K10b."""

from mpcgpu_tpu_torch.parallel.batched import make_batched_sqp_solver
from mpcgpu_tpu_torch.parallel.batched_cuda import (build_kkt_schur_batched,
                                                    compute_dz_batched,
                                                    line_search_merits_batched,
                                                    make_batched_fused_solver,
                                                    pcg_solve_batched,
                                                    sqp_solve_batched_fused,
                                                    sqp_solve_batched_fused_sharded)
from mpcgpu_tpu_torch.parallel.distributed import (DistKnotMesh,
                                                   initialize_distributed,
                                                   make_host_aligned_mesh)
from mpcgpu_tpu_torch.parallel.mesh import (KnotMesh, make_mesh,
                                            shard_batched_problem)
from mpcgpu_tpu_torch.parallel.pcg_sharded import (btd_matvec_halo,
                                                   pcg_solve_sharded,
                                                   pcg_solve_two_slab)
from mpcgpu_tpu_torch.parallel.sqp_sharded import (make_sharded_sqp_solver,
                                                   sqp_solve_sharded)

__all__ = ["DistKnotMesh", "KnotMesh", "btd_matvec_halo",
           "build_kkt_schur_batched", "compute_dz_batched",
           "initialize_distributed", "line_search_merits_batched",
           "make_batched_fused_solver", "make_batched_sqp_solver",
           "make_host_aligned_mesh", "make_mesh", "make_sharded_sqp_solver",
           "pcg_solve_batched", "pcg_solve_sharded", "pcg_solve_two_slab",
           "shard_batched_problem", "sqp_solve_batched_fused",
           "sqp_solve_batched_fused_sharded", "sqp_solve_sharded"]
