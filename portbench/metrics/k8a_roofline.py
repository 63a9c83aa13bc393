"""K8a's share of its roofline (%): the least time for the traced calls
(``counts/k8a.py`` at the cell's batch, over the card's peaks) over K8a's
device time in the trace."""

from portbench.counts import k8a
from portbench.counts._ops import least_s


def read(rec):
    tr, peaks, cfg = rec.get("traced"), rec["peaks"], rec["cfg"]
    if not tr or not peaks or not tr["device_s_by_op"].get(k8a.KERNEL):
        return None
    least = tr["calls_by_op"][k8a.KERNEL] * least_s(
        *k8a.work(cfg["knots"], cfg["nq"], cfg["batch"]), peaks)
    return 100.0 * least / tr["device_s_by_op"][k8a.KERNEL]
