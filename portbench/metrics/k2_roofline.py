"""K2's share of its roofline (%): the least time the card could take for
the traced K2 calls (``counts/k2.py`` at the iterations each solve took,
over the card's peaks) over K2's device time in the trace.  The profiler
now and then drops a kernel's record (399 of 400 calls in 2 of 12
segments on the H100), so the least time is the mean over the solves the
loop counted, times the calls the trace holds."""

from portbench.counts import k2
from portbench.counts._ops import least_s


def read(rec):
    tr, peaks, cfg = rec.get("traced"), rec["peaks"], rec["cfg"]
    if not tr or not peaks or not tr["device_s_by_op"].get(k2.KERNEL):
        return None
    iters = tr["pcg_iters"]
    iters = iters[iters >= 0]
    if not iters.numel():
        return None
    least = sum(least_s(*k2.work(cfg["knots"], cfg["nq"], int(i)), peaks)
                for i in iters) / iters.numel() * tr["calls_by_op"][k2.KERNEL]
    return 100.0 * least / tr["device_s_by_op"][k2.KERNEL]
