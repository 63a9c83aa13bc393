"""Profiling and tracing helpers.

Port of ``mpcgpu_tpu/utils/profiling.py``.  The reference instruments with
CLOCK_MONOTONIC and cudaDeviceSynchronize fences (pcg/sqp.cuh:33-35,
experiment.cuh:14); here that is a wall timer that synchronizes the card of
every CUDA tensor it is given before it reads the clock (the port's
``block_until_ready``), and a ``torch.profiler`` trace for kernel-level
breakdowns.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


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
    ``trace_path`` attribute."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "mpcgpu_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
