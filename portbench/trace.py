"""The reduction of a torch.profiler trace to the device's busy time, its
operations by name and its idle gaps by what the host was doing.

The traced segment is the span of the ``WINDOW`` annotation, stretched to
cover every device operation the profile holds: the profile holds only the
segment's updates, and the profiler's device timestamps can land a few
milliseconds past the host's end of the annotation (16 of 400 K2 calls in
one segment on the H100).  Device time is the union of the intervals of
every device operation (kernels, copies, fills); an idle gap is an
interval of the segment in which no device operation ran, named by the
innermost host operation that covered its middle.  Times are seconds.
"""

from __future__ import annotations

import bisect
import collections
import re

WINDOW = "portbench.traced_window"
# host events of the profiler's own, which name no work of the program
PROFILER_OWN = ("Activity Buffer Request", "ProfilerStep")


def kernel_key(name: str) -> str:
    """A device operation's name without its return type and arguments,
    bool template arguments spelled true / false."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name.replace("(bool)1", "true").replace("(bool)0", "false").strip()


def _is_device(ev) -> bool:
    return ev.device_type.name in ("CUDA", "PrivateUse1")


def _is_annotation(ev) -> bool:
    """A ``record_function`` span (the profiler also mirrors it onto the
    device's timeline, where it is no device operation)."""
    return ev.name == WINDOW or getattr(ev, "is_user_annotation", False)


def _innermost(host, starts, t, reach: int = 256) -> str:
    """The name of the latest-starting host operation that covers time t
    (host operations of one thread nest, so that is the innermost), found
    among the ``reach`` operations that started last before t; Python
    between operations where none does."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - reach, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "python between operations"


def reduce(prof) -> dict:
    events = prof.events()
    win = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not win:
        raise RuntimeError("the traced window's annotation is missing")
    dev = sorted((e.time_range.start, e.time_range.end, kernel_key(e.name))
                 for e in events if _is_device(e) and not _is_annotation(e))
    w0 = min([win[0].time_range.start] + [d[0] for d in dev[:1]])
    w1 = max([win[0].time_range.end] + [d[1] for d in dev])
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if not _is_device(e) and not _is_annotation(e)
                  and not e.name.startswith(PROFILER_OWN)
                  and e.thread == win[0].thread
                  and e.time_range.end > w0 and e.time_range.start < w1)
    starts = [h[0] for h in host]

    per_op = collections.Counter()
    calls = collections.Counter()
    for a, b, key in dev:
        per_op[key] += (b - a) * 1e-6
        calls[key] += 1
    busy, gaps, cursor = 0.0, [], w0
    for a, b, _ in dev:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if cursor < w1:
        gaps.append((cursor, w1))

    by_host = collections.Counter()
    for a, b in gaps:
        by_host[_innermost(host, starts, 0.5 * (a + b))] += (b - a) * 1e-6
    return dict(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
        device_ops=[[k, v] for k, v in per_op.most_common(10)],
        idle_gaps=[[k, v] for k, v in by_host.most_common(10)],
        device_s_by_op=dict(per_op), calls_by_op=dict(calls))
