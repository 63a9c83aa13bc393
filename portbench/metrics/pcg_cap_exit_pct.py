"""Share of the linear solves that stopped at the PCG cap (%): the
program's ``pcg.cap_exits`` over ``pcg.solves``, per instance and SQP
iteration, frozen instances left out, over the traced segment
(``mpcgpu_tpu_torch/utils/profiling.py``).  None where the program counts
no solves."""


def read(rec):
    if not rec.get("traced"):
        return None
    from mpcgpu_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters()
    return 100.0 * c["pcg.cap_exits"] / c["pcg.solves"] if c["pcg.solves"] else None
