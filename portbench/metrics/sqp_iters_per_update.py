"""SQP iterations a control update's solve ran, averaged over the measured
window's updates: the iterations with a PCG count in the solve's own
``pcg_iters`` (for a batch, the iterations of its loop, which runs while
any instance does)."""


def read(rec):
    it = rec["pcg_iters"]                      # (updates, B, sqp iterations)
    if not it.numel():
        return None
    return float((it >= 0).any(1).sum(-1).double().mean())
