"""Host time of one SQP iteration's CUDA graph replay (us): the program's
``sqp.replay`` spans (the ``graph.replay()`` call) over their count in the
traced segment (``mpcgpu_tpu_torch/utils/profiling.py``,
``solver/sqp_graph.py``).  None where the program records no replay."""


def read(rec):
    if not rec.get("traced"):
        return None
    from mpcgpu_tpu_torch.utils import profiling

    spans = [s for s in getattr(profiling, "spans", list)() if s.name == "sqp.replay"]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e3
