"""The device's idle share of the traced segment (%): 100 minus the union
of its device operations' intervals over the segment's host wall time
(torch.profiler)."""


def read(rec):
    tr = rec.get("traced")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
