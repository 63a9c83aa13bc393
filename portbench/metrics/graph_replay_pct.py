"""Share of the SQP iterations run by a CUDA graph replay (%): the
program's ``sqp.replays`` over its ``pcg.solves`` (one per SQP iteration),
over the traced segment (``mpcgpu_tpu_torch/utils/profiling.py``,
``solver/sqp_graph.py``).  None where the program counts no solves or no
replays."""


def read(rec):
    if not rec.get("traced"):
        return None
    from mpcgpu_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters()
    if "sqp.replays" not in c or not c["pcg.solves"]:
        return None
    return 100.0 * c["sqp.replays"] / c["pcg.solves"]
