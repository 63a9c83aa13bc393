"""K8b's share of its roofline (%): the least time for the traced calls
(``counts/k8b.py`` with the CG steps each call's instances took, over
the card's peaks) over K8b's device time in the trace.  As for K2, the
mean over the calls the loop counted, times the calls the trace holds."""

from portbench.counts import k8b
from portbench.counts._ops import least_s


def read(rec):
    tr, peaks, cfg = rec.get("traced"), rec["peaks"], rec["cfg"]
    if not tr or not peaks or not tr["device_s_by_op"].get(k8b.KERNEL):
        return None
    it = tr["pcg_iters"]                       # (updates, B, sqp iterations)
    calls = [(u, j) for u in range(it.shape[0]) for j in range(it.shape[2])
             if bool((it[u, :, j] >= 0).any())]
    if not calls:
        return None
    least = sum(least_s(*k8b.work(cfg["knots"], cfg["nq"], cfg["batch"],
                                  int((it[u, :, j][it[u, :, j] >= 0] + 1).sum())),
                        peaks) for u, j in calls) / len(calls)
    calls_traced = tr["calls_by_op"][k8b.KERNEL]
    return 100.0 * least * calls_traced / tr["device_s_by_op"][k8b.KERNEL]
