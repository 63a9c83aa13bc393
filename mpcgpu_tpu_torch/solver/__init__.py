"""KKT assembly, merit, the K1/K3 kernels and the SQP loop (port of
mpcgpu_tpu.solver)."""

from mpcgpu_tpu_torch.solver.kkt import KKTBlocks, build_kkt
from mpcgpu_tpu_torch.solver.merit import merit_function, line_search_merits


def __getattr__(name):
    # the SQP loop, loaded on first use: it imports the kernel wrappers,
    # which import solver.kkt
    if name in ("SQPResult", "sqp_solve", "make_sqp_solver"):
        from mpcgpu_tpu_torch.solver import sqp
        return getattr(sqp, name)
    raise AttributeError(name)


__all__ = ["KKTBlocks", "build_kkt", "merit_function", "line_search_merits",
           "SQPResult", "sqp_solve", "make_sqp_solver"]
