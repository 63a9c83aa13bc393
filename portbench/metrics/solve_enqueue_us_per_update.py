"""Host time of the port's solve call per control update (us), its waits
on the card left out: the program's own ``sqp.solve`` spans less the
``sqp.stop_read`` spans inside them, over the solves of the traced
segment (``mpcgpu_tpu_torch/utils/profiling.py``, recorded while the
segment's profiler runs).  None where the program records no spans."""


def read(rec):
    if not rec.get("traced"):
        return None
    from mpcgpu_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", list)()
    solves = [s.end_ns - s.start_ns for s in spans if s.name == "sqp.solve"]
    if not solves:
        return None
    wait = sum(s.end_ns - s.start_ns for s in spans if s.name == "sqp.stop_read")
    return (sum(solves) - wait) / len(solves) / 1e3
