"""Share of the line searches that took no step (%): the program's
``ls.rejects`` (``ls_alpha_idx`` -1) over ``ls.searches``, per instance and
SQP iteration, frozen instances left out, over the traced segment
(``mpcgpu_tpu_torch/utils/profiling.py``).  None where the program counts
no searches."""


def read(rec):
    if not rec.get("traced"):
        return None
    from mpcgpu_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters()
    return 100.0 * c["ls.rejects"] / c["ls.searches"] if c["ls.searches"] else None
