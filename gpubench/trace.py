"""Reading the device trace of the traced window.

``torch.profiler`` (CPU and CUDA activities) runs over the first calls
of the window; its Chrome trace is read back here into a
:class:`Device` summary:

- device events: kernels, memcopies and memsets, with their start and
  length on the device (microseconds) and, for memcopies, bytes;
- each device event's stage: the program's range whose name starts with
  the entry's prefix (``l1_to_l2.<stage>``) open on the host when the
  event was launched (through the launch's correlation id), or, for an
  event with no launch record, the device-side copy of that range that
  contains it;
- the host ranges ``gpubench.<name>`` of :mod:`.spans` and
  ``gpubench.call`` around each call.

The device is busy where a kernel runs (:data:`KERNEL`): copies and
memsets are device operations too (:meth:`Device.busy_us` takes them
with ``cats=DEVICE_CATS``), but a pageable copy's length on the device
is paced by the host's copy through a bounce buffer, so idle time is
counted against kernels alone and the copies' time is read apart
(:meth:`Device.copy_us`).
"""

import bisect
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL = ("kernel",)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _intervals(events):
    return sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events)


def _find(starts, ivs, t):
    """The interval of ``ivs`` (sorted, not overlapping) containing ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
        return ivs[i]
    return None


def short(name, n=96):
    """A device operation's name, cut to ``n`` characters."""
    return name if len(name) <= n else name[: n - 3] + "..."


def merge(ivs):
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Device:
    """What the trace says of the traced calls (times in microseconds)."""

    def __init__(self, events, ranges):
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        launch = {e["args"]["correlation"]: e["ts"] for e in events
                  if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                  and "correlation" in e.get("args", {})}
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        stages = _intervals(e for e in host if e["name"].startswith(ranges))
        gstages = _intervals(e for e in events if e.get("ph") == "X"
                             and e.get("cat") == "gpu_user_annotation"
                             and e["name"].startswith(ranges))
        self.calls = _intervals(e for e in host if e["name"] == "gpubench.call")
        self.host_spans = _intervals(e for e in host if e["name"].startswith("gpubench."))
        s0, g0 = [s[0] for s in stages], [s[0] for s in gstages]
        self.events = []
        for e in dev:
            corr = e.get("args", {}).get("correlation")
            where = None
            if corr in launch:
                where = _find(s0, stages, launch[corr])
            else:
                where = _find(g0, gstages, e["ts"])
            self.events.append(dict(
                name=e["name"], cat=e["cat"], ts=e["ts"], dur=e.get("dur", 0.0),
                bytes=e.get("args", {}).get("bytes", 0),
                stage=where[2] if where else None))
        self.window = (self.calls[0][0], self.calls[-1][1]) if self.calls else None

    @property
    def ncalls(self):
        return len(self.calls)

    def stage_us(self, prefix=""):
        """Device microseconds of the events under the program's ranges
        that start with ``prefix``, summed over the traced calls."""
        return sum(e["dur"] for e in self.events
                   if e["stage"] is not None and e["stage"].startswith(prefix))

    def h2d_bytes(self):
        return sum(e["bytes"] for e in self.events
                   if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"])

    def copy_us(self):
        """Device microseconds of the memcopies and memsets, both ways."""
        return sum(e["dur"] for e in self.events if e["cat"] != "kernel")

    def busy(self, cats=KERNEL):
        """Disjoint intervals inside the traced window in which an event
        of ``cats`` runs on the device."""
        if self.window is None:
            return []
        w0, w1 = self.window
        ivs = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in self.events
               if e["cat"] in cats]
        return merge([iv for iv in ivs if iv[1] > iv[0]])

    def busy_us(self, cats=KERNEL):
        return sum(b - a for a, b in self.busy(cats))

    def window_us(self):
        return None if self.window is None else self.window[1] - self.window[0]

    def top_ops(self, n=10):
        """The ``n`` device operations with the most time: [[name, s]]."""
        tot = defaultdict(float)
        for e in self.events:
            tot[e["name"]] += e["dur"]
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[short(k), v * 1e-6] for k, v in top]

    def idle_by_host(self, n=10):
        """Idle device time (no kernel running) inside the window, by what
        the host was doing: each stretch of an idle gap goes to the innermost host span open
        over it: a ``gpubench.`` span (``call`` where the call is open
        but no wrapped function), ``between calls`` outside every call.
        [[name, s]], the ``n`` largest."""
        if self.window is None:
            return []
        w0, w1 = self.window
        gaps, t = [], w0
        for a, b in self.busy():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        pts = sorted({w0, w1} | {x for sp in self.host_spans for x in sp[:2] if w0 < x < w1})
        tot = defaultdict(float)
        j = 0
        for a, b in zip(pts, pts[1:]):
            mid = 0.5 * (a + b)
            inner = [sp for sp in self.host_spans if sp[0] <= mid <= sp[1]]
            name = (min(inner, key=lambda sp: sp[1] - sp[0])[2].replace("gpubench.", "")
                    if inner else "between calls")
            while j < len(gaps) and gaps[j][1] <= a:
                j += 1
            k = j
            while k < len(gaps) and gaps[k][0] < b:
                tot[name] += min(b, gaps[k][1]) - max(a, gaps[k][0])
                k += 1
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-6] for k, v in top]


def read_chrome_trace(prof, path, ranges):
    """Export ``prof``'s trace to ``path``, read it and delete it."""
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return Device(data["traceEvents"] if isinstance(data, dict) else data, ranges)
