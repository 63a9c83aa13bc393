"""Host time a control update's solve waits on the card (us): the
program's ``sqp.stop_read`` spans (the host's read of the SQP loop's stop
flag) over the solves of the traced segment
(``mpcgpu_tpu_torch/utils/profiling.py``).  None where the program records
no spans."""


def read(rec):
    if not rec.get("traced"):
        return None
    from mpcgpu_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", list)()
    solves = sum(s.name == "sqp.solve" for s in spans)
    if not solves:
        return None
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name == "sqp.stop_read") / solves / 1e3
