"""Profiling and tracing helpers.

Port of ``mpcgpu_tpu/utils/profiling.py``.  The reference instruments with
CLOCK_MONOTONIC and cudaDeviceSynchronize fences (pcg/sqp.cuh:33-35,
experiment.cuh:14); here that is a wall timer that synchronizes the card of
every CUDA tensor it is given before it reads the clock (the port's
``block_until_ready``), and a ``torch.profiler`` trace for kernel-level
breakdowns.

Inside the SQP loops (``solver/sqp.py::sqp_solve``,
``parallel/batched_cuda.py::sqp_solve_batched_fused``) the module records
spans and counters, exactly while a ``torch.profiler`` session is active
(``trace()`` or any other) and never otherwise: with no session a solve
pays one flag check per span boundary and records nothing.  Spans
(``SPAN_NAMES``): ``sqp.solve``, one per solve call, and under it per SQP
iteration ``sqp.kkt``, ``sqp.linsys``, ``sqp.dz`` (absent where the linear
solve returns dz), ``sqp.merits``, ``sqp.step``, and ``sqp.stop_read``, the
host's read of the stop flag (the solve's only wait on the card); where
``solver/sqp_graph.py`` runs an iteration as a CUDA graph replay,
``sqp.replay`` (the replay call) in place of the phases.  Each
is kept in memory (name, ``time.perf_counter_ns()`` start and end, parent,
solve id, SQP iteration, batch size) and entered as a profiler range of
its name, so the session's events and Chrome trace hold the spans on the
device trace's clock.  Counters (``COUNTER_NAMES``), per instance and SQP
iteration, frozen instances of a batch left out: linear solves and those
that stopped at the PCG cap, line searches and those that took no step,
linear solves whose lam holds a NaN or inf (the f32 breakdown's alarm),
and the halvings of the steps the line searches took (the sum of the
accepted ``ls_alpha_idx``: 0 for alpha = 1, 7 for 1/128); and on the host
(``HOST_COUNTER_NAMES``) the SQP iterations run by a graph replay, the
graphs captured, and K8a's knot stages and knots (instances x the knots
its windows linearize, halo knots included, and instances x N, per
launch).  The others stay on the card,
as references to the tensors the loop writes (its result buffers and each
linear solve's lam, or a copy where the graph's next replay overwrites it;
a large lam is reduced per instance when the solve ends, outside its
phases), and are reduced and read back once, by ``counters()``.
``spans()``, ``counters()`` read the recorder, ``reset()`` clears it;
``trace()`` clears it when it starts.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

try:  # a profiler range at ~1 us, against ~10 for record_function
    from torch._C._profiler import _RecordFunctionFast as _ProfilerRange
except ImportError:
    from torch.autograd.profiler import record_function as _ProfilerRange
try:  # the profiler's per-operation callbacks, on or off for this thread
    from torch._C._autograd import _enable_record_function
except ImportError:
    def _enable_record_function(enable: bool) -> None:
        pass


def _sync(*outputs) -> None:
    """Wait for the card of every CUDA tensor among ``outputs`` (nested in
    tuples, lists, dicts or NamedTuples); CPU tensors and other values are
    ready already."""
    cards = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                cards.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                visit(v)

    visit(outputs)
    for card in cards:
        torch.cuda.synchronize(card)


class WallTimer:
    """Blocking wall timer (time_delta_us_timespec equivalent): waits for
    all outputs before reading the clock."""

    def __init__(self):
        self.samples_us = []

    @contextlib.contextmanager
    def measure(self, *outputs):
        """Time the block; ``outputs`` are tensors (or containers of them)
        the block writes in place, whose cards are synchronized before the
        clock is read."""
        t0 = time.perf_counter()
        yield
        _sync(*outputs)
        self.samples_us.append((time.perf_counter() - t0) * 1e6)


def time_jitted(fn, *args, reps: int = 20, warmup: int = 2) -> float:
    """Median wall time (us) of fn(*args) after ``warmup`` calls.  Times any
    callable (the name is the JAX counterpart's, which times a jitted
    function with its compile excluded); each call is timed up to the
    synchronization of the card of every CUDA tensor it returns."""
    for _ in range(warmup):
        _sync(fn(*args))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        samples.append((time.perf_counter() - t0) * 1e6)
    samples.sort()
    return samples[len(samples) // 2]


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``torch.profiler`` trace of the block, CPU and (where there is a card)
    CUDA activity, written as a Chrome trace ``trace_<pid>_<ns>.json`` into
    ``logdir`` (default: ``mpcgpu_tpu_torch_trace`` in the temporary
    directory).  Yields the profiler, so the caller can read
    ``key_averages()`` after the block; the trace's path is then its
    ``trace_path`` attribute.  Clears the spans and counters recorder when
    it starts; the block's solves record into it (module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "mpcgpu_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


# ---- spans and counters of the SQP loops ---------------------------------

SPAN_NAMES = ("sqp.solve", "sqp.kkt", "sqp.linsys", "sqp.dz", "sqp.merits",
              "sqp.step", "sqp.stop_read", "sqp.replay")
COUNTER_NAMES = ("pcg.solves", "pcg.cap_exits", "ls.searches", "ls.rejects",
                 "pcg.nonfinite", "ls.halvings")
# counted on the host as the solves run: SQP iterations run by a CUDA graph
# replay, and graphs captured (solver/sqp_graph.py); K8a's knot stages and
# knots (parallel/batched_cuda.py)
HOST_COUNTER_NAMES = ("sqp.replays", "sqp.captures", "k8a.knot_stages", "k8a.knots")


class Span(NamedTuple):
    name: str
    start_ns: int           # time.perf_counter_ns()
    end_ns: int
    parent: int | None      # index in spans() of the enclosing span
    solve: int              # one id per solve call, shared by its spans
    iteration: int | None   # SQP iteration (None on sqp.solve)
    batch: int              # instances the solve carries


# A lam of at most this many bytes (one arm's at N = 64: 3.5 KiB) is kept
# as it is until read: no kernel runs for it inside the solve.  A larger one
# (a batch's: 0.9 MiB at 256 arms) is reduced when its solve ends to whether
# each instance's lam is finite: kept whole, it would grow the allocator by
# a segment every two solves.
KEEP_LAM_BYTES = 64 << 10


class _Recorder:
    """What the solves recorded: each span's (name, start, parent, solve,
    iteration, batch) and, apart, its end (None while it is open), so that
    every entry is a tuple of atoms or an int, which the garbage collector
    stops tracking; per solve its result buffers and, per linear solve, its
    lam or whether each instance's lam is finite (bool, shape (...))."""

    def __init__(self):
        self.spans, self.ends, self.solves, self.solve_ids = [], [], [], 0
        self.host_counts = dict.fromkeys(HOST_COUNTER_NAMES, 0)


def _finite(lam):
    """Per instance, whether lam (..., N, nx) holds no NaN or inf: lam * 0 is
    0 where lam is finite and NaN elsewhere.  Multiply, compare and ``all``
    are kernels the SQP loops launch themselves, so none of the three loads
    its module for the first time inside a traced segment (there a norm, a
    sum, an amax or ``isfinite`` stalls the first traced solve by 12-54 ms
    on the H100)."""
    return torch.gt(lam * 0.0, -1.0).flatten(-2).all(-1)


_RECORDER = _Recorder()


def reset() -> None:
    """Clear the recorded spans and counters."""
    global _RECORDER
    _RECORDER = _Recorder()


def spans() -> list:
    """The recorded spans (``Span``) in the order they began."""
    rec = _RECORDER
    return [Span(name, start, end, parent, solve, iteration, batch)
            for (name, start, parent, solve, iteration, batch), end
            in zip(rec.spans, rec.ends)]


def counters() -> dict:
    """The recorded counters (``COUNTER_NAMES``) summed over the solves, read
    back from the card at once, and the host's (``HOST_COUNTER_NAMES``).
    Every SQP iteration an instance runs is one linear solve and one line
    search, so ``pcg.solves`` and ``ls.searches`` are one count under two
    names."""
    by_device = {}
    for pcg_iters, converged, alpha_idx, lams in _RECORDER.solves:
        k = len(lams)
        if not k:
            continue
        ran = pcg_iters[..., :k] >= 0
        finite = torch.stack([kept if kept.dtype == torch.bool else _finite(kept)
                              for kept in lams], dim=-1)
        runs = ran.sum()
        idx = alpha_idx[..., :k]
        row = torch.stack([runs, (ran & ~converged[..., :k]).sum(), runs,
                           (ran & (idx == -1)).sum(), (ran & ~finite).sum(),
                           torch.where(ran & (idx >= 0), idx, 0).sum()])
        by_device[row.device] = by_device.get(row.device, 0) + row
    totals = [0] * len(COUNTER_NAMES)
    for row in by_device.values():
        totals = [a + b for a, b in zip(totals, row.tolist())]
    return dict(zip(COUNTER_NAMES, totals)) | _RECORDER.host_counts


def solve_trace(batch: int):
    """The recorder of one solve call of ``batch`` instances, which opens its
    ``sqp.solve`` span; None, at the cost of one flag check, when no
    profiler session is active."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    return SolveTrace(batch)


class SolveTrace:
    """One solve's spans and counters (module docstring).  The solve calls
    ``phase`` at each boundary between its phases, ``lam_solved`` on each
    linear solve's lam, ``count`` on each host event it counts and
    ``finish`` on its result."""

    __slots__ = ("_rec", "_solve", "_batch", "_iteration", "_top", "_top_range",
                 "_open", "_open_range", "_lams")

    def __init__(self, batch: int):
        # the recorder this solve began in, whatever reset() does meanwhile
        rec = self._rec = _RECORDER
        self._solve, self._batch = rec.solve_ids, int(batch)
        rec.solve_ids += 1
        self._iteration, self._open, self._open_range = None, None, None
        self._lams = []
        self._top, self._top_range = self._begin("sqp.solve", None)

    def _begin(self, name: str, parent):
        """Enter the profiler range, then read the clock; returns the span's
        index and range."""
        profiler_range = _ProfilerRange(name)
        profiler_range.__enter__()
        rec = self._rec
        rec.spans.append((name, time.perf_counter_ns(), parent, self._solve,
                          self._iteration, self._batch))
        rec.ends.append(None)
        return len(rec.ends) - 1, profiler_range

    def phase(self, name: str | None, iteration: int | None = None) -> None:
        """End the open phase span and begin ``name`` (none where None) under
        the solve's span, in SQP iteration ``iteration`` (else the last
        given)."""
        if self._open is not None:
            self._rec.ends[self._open] = time.perf_counter_ns()
            self._open_range.__exit__(None, None, None)
            self._open = None
        if iteration is not None:
            self._iteration = iteration
        if name is not None:
            self._open, self._open_range = self._begin(name, self._top)

    def lam_solved(self, lam, copy: bool = False) -> None:
        """Keep a linear solve's lam, for the count of non-finite solves:
        the tensor itself (the eager loops write no lam in place), or with
        ``copy`` a copy of it, made with the profiler's per-operation
        callbacks off (a CUDA graph's lam, which its next replay
        overwrites)."""
        if copy:
            _enable_record_function(False)
            try:
                lam = lam.clone()
            finally:
                _enable_record_function(True)
        self._lams.append(lam)

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the host counter ``name`` (``HOST_COUNTER_NAMES``)."""
        self._rec.host_counts[name] += n

    def finish(self, result) -> None:
        """End the open phase; reduce each large lam (KEEP_LAM_BYTES); end the
        solve's span; keep the result's per-iteration ``pcg_iters``,
        ``pcg_converged`` and ``ls_alpha_idx`` for the counters.  The
        reductions run with the profiler's per-operation callbacks off (the
        session is active, so they were on): under a session each operation
        would cost the host ~35 us on the H100's host, not ~12.  Their
        kernels stay on the device trace."""
        self.phase(None)
        lams = self._lams
        if any(lam.numel() * lam.element_size() > KEEP_LAM_BYTES for lam in lams):
            _enable_record_function(False)
            try:
                lams = [lam if lam.numel() * lam.element_size() <= KEEP_LAM_BYTES
                        else _finite(lam) for lam in lams]
            finally:
                _enable_record_function(True)
        rec = self._rec
        rec.ends[self._top] = time.perf_counter_ns()
        self._top_range.__exit__(None, None, None)
        rec.solves.append((result.pcg_iters, result.pcg_converged,
                           result.ls_alpha_idx, lams))
