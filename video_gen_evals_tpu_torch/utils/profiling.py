"""Tracing and profiling hooks.

Port of ``video_gen_evals_tpu/utils/profiling.py`` on ``torch.profiler``:
:func:`annotate` names a span of the timeline (and an NVTX range on CUDA),
:func:`trace` captures a run's host and device activity to a Chrome trace
under ``trace_dir`` or ``$VGE_TRACE_DIR`` (a no-op when neither is set, so
pipelines can wrap their phases unconditionally), and :class:`StepTimer`
counts step rates for the metrics stream.
"""

from __future__ import annotations

import contextlib
import os
import time
import typing as T

import torch


@contextlib.contextmanager
def annotate(name: str):
    """A named span: ``torch.profiler.record_function`` and, where CUDA is
    up, an NVTX range."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(trace_dir: T.Optional[str] = None):
    """Profile the enclosed block (CPU, and CUDA where it is up) and write
    ``<trace_dir>/trace_<pid>_<n>.json`` (Chrome trace format). Yields the
    profiler, or None when neither ``trace_dir`` nor ``$VGE_TRACE_DIR`` is
    set."""
    trace_dir = trace_dir or os.environ.get("VGE_TRACE_DIR")
    if not trace_dir:
        yield None
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    n = len([f for f in os.listdir(trace_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}_{n}.json"))


class StepTimer:
    """Step-time / throughput counter for the metrics stream."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self.steps = 0
        self.items = 0

    def tick(self, items: int = 1) -> None:
        self.steps += 1
        self.items += items

    def rates(self) -> T.Dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "seconds": dt,
            "steps_per_sec": self.steps / dt,
            "items_per_sec": self.items / dt,
        }
