"""Host time of the SQP loop's own tensor ops per SQP iteration (us): the
program's ``sqp.step`` spans (the line-search choice, the iterate update,
the batch's freeze, the forcing, the writes into the result buffers) over
the SQP iterations of the traced segment, one ``sqp.kkt`` each
(``mpcgpu_tpu_torch/utils/profiling.py``).  None where the program records
no spans."""


def read(rec):
    if not rec.get("traced"):
        return None
    from mpcgpu_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", list)()
    iters = sum(s.name == "sqp.kkt" for s in spans)
    if not iters:
        return None
    return sum(s.end_ns - s.start_ns for s in spans if s.name == "sqp.step") / iters / 1e3
