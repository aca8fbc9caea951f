"""Profiling: ``torch.profiler`` traces and wall-clock step timing.

Port of ``tpu_se/utils/profiling.py``.  The reference's only tracing was a
wall-clock printf macro (``BP_GPU.h:8-16``); here the tool is PyTorch's
profiler, whose Chrome traces open in Perfetto or TensorBoard and show
each kernel's device time beside the host's launches.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace around a code block and write it,
    as one Chrome-trace ``*.pt.trace.json`` file, into ``log_dir`` (made if
    missing).  The host side is always traced, the card's kernels and
    copies whenever a CUDA card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Rolling wall-clock timer with summary stats for step loops."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self) -> dict:
        if not self.times:
            return {"count": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "count": n,
            "mean_ms": 1e3 * sum(ts) / n,
            "p50_ms": 1e3 * ts[n // 2],
            "min_ms": 1e3 * ts[0],
            "max_ms": 1e3 * ts[-1],
        }
