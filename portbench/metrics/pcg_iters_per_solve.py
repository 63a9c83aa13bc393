"""PCG iterations per linear solve: the solves' own ``pcg_iters``, averaged
over the window's SQP iterations (and instances), -1 pads left out."""


def read(rec):
    it = rec["pcg_iters"]
    used = it[it >= 0]
    return float(used.double().mean()) if used.numel() else None
