"""Profiling hooks.

- :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (``trace.json``, for ``chrome://tracing`` or Perfetto)
  of any pipeline section, with the card's kernels where there is one.
- :class:`StageTimer` — host-side wall-clock stage accounting that
  lands in the ProcessLog / the L2 ``processinfo`` tree.
"""

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir, create_perfetto_link=False):
    """Profile the body with ``torch.profiler`` (the CPU, and CUDA when a
    GPU is present) and write its Chrome trace to
    ``log_dir/trace.json``, also when the body raises.  Yields the
    profiler (``key_averages()`` and the rest).  ``create_perfetto_link``
    is accepted for the JAX package's signature and does nothing."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StageTimer:
    """Accumulates named stage wall-clock durations."""

    def __init__(self, mylog=None):
        self.stages = {}
        self._mylog = mylog

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            if self._mylog is not None:
                self._mylog.append(f"[timing] {name}: {dt * 1e3:.1f} ms\n")

    def summary(self):
        return dict(self.stages)
