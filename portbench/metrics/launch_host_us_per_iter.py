"""Host time of the kernel wrappers per SQP iteration (us): the program's
``sqp.kkt``, ``sqp.linsys``, ``sqp.dz`` and ``sqp.merits`` spans (checks,
outputs, launches) over the SQP iterations of the traced segment, one
``sqp.kkt`` each (``mpcgpu_tpu_torch/utils/profiling.py``).  None where
the program records no spans."""

PHASES = ("sqp.kkt", "sqp.linsys", "sqp.dz", "sqp.merits")


def read(rec):
    if not rec.get("traced"):
        return None
    from mpcgpu_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", list)()
    iters = sum(s.name == "sqp.kkt" for s in spans)
    if not iters:
        return None
    return sum(s.end_ns - s.start_ns for s in spans if s.name in PHASES) / iters / 1e3
