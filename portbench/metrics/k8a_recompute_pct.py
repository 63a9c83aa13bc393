"""K8a's knot stages run again for halo knots (%): 100 x (the program's
``k8a.knot_stages`` - ``k8a.knots``) / ``k8a.knots``, over the traced
segment (``mpcgpu_tpu_torch/utils/profiling.py``; each K8a launch adds
instances x the knots its windows linearize and instances x N).  None
where the program counts no K8a knots."""


def read(rec):
    if not rec.get("traced"):
        return None
    from mpcgpu_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters()
    if not c.get("k8a.knots"):
        return None
    return 100.0 * (c["k8a.knot_stages"] - c["k8a.knots"]) / c["k8a.knots"]
