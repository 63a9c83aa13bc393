"""Halvings of the step a line search took, per line search that took one:
the program's ``ls.halvings`` (the sum of the accepted ``ls_alpha_idx``: 0
for alpha = 1, 7 for 1/128) over ``ls.searches`` less ``ls.rejects``, per
instance and SQP iteration, frozen instances left out, over the traced
segment (``mpcgpu_tpu_torch/utils/profiling.py``).  None where the program
counts no halvings or no search took a step."""


def read(rec):
    if not rec.get("traced"):
        return None
    from mpcgpu_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters()
    took = c["ls.searches"] - c["ls.rejects"]
    if "ls.halvings" not in c or not took:
        return None
    return c["ls.halvings"] / took
