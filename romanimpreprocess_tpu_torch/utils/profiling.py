"""Profiling: one recorder of named spans and counters, and the trace.

- :func:`span` — a context manager (or decorator) around one step of the
  program.  While a ``torch.profiler`` records, it opens a
  ``torch.profiler.record_function`` range of the same name, so the step
  lands in the profiler's trace on the clock of the device's events, and
  adds to the recorder, per name: the count, the wall time, the self
  time (the wall time less that of the spans opened inside it on the
  same thread), and the calling thread's minor page faults and system
  CPU time (``getrusage``; a sandboxed kernel may count no faults).
  While no profiler records, a span reads one flag and does nothing
  else.
- :class:`StageRanges` — the stages of a device function as a run of
  spans ``<prefix>.<stage>``, none inside another.
- :func:`count` — adds to a named counter, under the same gate.
- :func:`gauge` — sets a named level (the last value set), under the
  same gate.
- :func:`snapshot` / :func:`reset` — what the recorder holds, and
  clearing it.
- :func:`trace` — a context manager around ``torch.profiler`` writing a
  Chrome trace (``trace.json``, for ``chrome://tracing`` or Perfetto)
  and the recorder's :func:`snapshot` of the body (``spans.json``).

The counters the program keeps: ``h2d_bytes`` (host -> device copies,
:mod:`..io.staging`), ``d2h_bytes`` (the counted copies back),
``d2h_pinned_bytes`` (those of them that went through page-locked host
memory, from a CUDA device),
``gather_bytes`` (rows the row-sharded core concatenates across slabs),
``cache.<name>.hit`` / ``cache.<name>.miss`` (the lookups of each
:class:`.hostcache.BoundedCache` and :class:`.hostcache.PackCache`),
``pack_hits`` / ``pack_misses`` (the per-pack lookups of a
:class:`.hostcache.PackCache`: the pack found whole on the device, or
not), ``pack_staged_bytes`` (cal-pack state copied to the device on a
miss: the cached :func:`..io.staging.stage`, the IPC precal, the kernel
planes), ``pack_evictions`` (packs the device cache dropped to admit
another, each inside the span ``host.pack_evict``).  The gauge:
``pack_resident_bytes``, the device bytes the resident packs hold.
"""

import contextlib
import functools
import json
import os
import resource
import threading
import time

import torch

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"

_autograd_profiler = torch.autograd.profiler
if hasattr(_autograd_profiler, "_is_profiler_enabled"):

    def recording():
        """True while a ``torch.profiler`` records."""
        return _autograd_profiler._is_profiler_enabled

else:  # pragma: no cover - torch builds without the Python flag
    recording = torch._C._autograd._profiler_enabled

_RUSAGE = getattr(resource, "RUSAGE_THREAD", resource.RUSAGE_SELF)
_LOCK = threading.Lock()
_LOCAL = threading.local()
#: name -> [count, total s, self s, minor faults, system CPU s]
_SPANS = {}
_COUNTERS = {}
_GAUGES = {}


def _open_spans():
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class span:
    """``with span(name): ...`` or ``@span(name)``: one recorded step.

    Nested spans on one thread give their parent its self time; the
    parent is the innermost span still open when the child closes.
    """

    __slots__ = ("name", "_range", "_t0", "_ru0", "_child")

    def __init__(self, name):
        self.name = name
        self._range = None

    def __enter__(self):
        if not recording():
            return self
        _open_spans().append(self)
        self._child = 0.0
        self._ru0 = resource.getrusage(_RUSAGE)
        self._t0 = time.perf_counter()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        rf = self._range
        if rf is None:
            return False
        self._range = None
        rf.__exit__(*exc)
        dt = time.perf_counter() - self._t0
        ru = resource.getrusage(_RUSAGE)
        stack = _open_spans()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # an inner span left open by an exception
            stack.remove(self)
        if stack:
            stack[-1]._child += dt
        with _LOCK:
            rec = _SPANS.setdefault(self.name, [0, 0.0, 0.0, 0, 0.0])
            rec[0] += 1
            rec[1] += dt
            rec[2] += dt - self._child
            rec[3] += ru.ru_minflt - self._ru0.ru_minflt
            rec[4] += ru.ru_stime - self._ru0.ru_stime
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


class StageRanges:
    """Labels a device function's stages as ``<prefix>.<stage>`` spans
    (:class:`span`, one flag read each when no profiler records):
    ``stage(name)`` ends the open span and opens the next."""

    def __init__(self, prefix):
        self._prefix, self._open = prefix, None

    def __call__(self, name):
        self.close()
        self._open = span(f"{self._prefix}.{name}")
        self._open.__enter__()

    def close(self):
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if recording():
        with _LOCK:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def gauge(name, value):
    """Set the level ``name`` to ``value`` while a profiler records: the
    recorder keeps the last value set, not a sum."""
    if recording():
        with _LOCK:
            _GAUGES[name] = value


def snapshot():
    """``{"spans": {name: {count, total_ms, self_ms, minflt, sys_ms}},
    "counters": {name: n}, "gauges": {name: value}}`` since the last
    :func:`reset`."""
    with _LOCK:
        spans = {k: {"count": c, "total_ms": 1e3 * t, "self_ms": 1e3 * s, "minflt": f,
                     "sys_ms": 1e3 * y}
                 for k, (c, t, s, f, y) in _SPANS.items()}
        return {"spans": spans, "counters": dict(_COUNTERS), "gauges": dict(_GAUGES)}


def reset():
    """Clear every span's, counter's and gauge's record."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()
        _GAUGES.clear()


@contextlib.contextmanager
def trace(log_dir, create_perfetto_link=False):
    """Profile the body with ``torch.profiler`` (the CPU, and CUDA when a
    GPU is present) and write its Chrome trace to ``log_dir/trace.json``
    and the recorder's :func:`snapshot` of the body (reset at the start)
    to ``log_dir/spans.json``, also when the body raises.  Yields the
    profiler (``key_averages()`` and the rest).  ``create_perfetto_link``
    is accepted for the JAX package's signature and does nothing."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
        with open(os.path.join(log_dir, SPANS_FILE), "w") as f:
            json.dump(snapshot(), f, indent=1, sort_keys=True)
