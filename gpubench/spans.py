"""Host spans around the program's functions, for the traced run only.

Where the program has no spans of its own in its host driver, an entry
(:mod:`.entries`) names the functions that one call of it goes through,
and :class:`Spans` wraps them from outside, only while installed.  Each
wrapper adds its wall time (host clock) to the open call's record and
opens a ``torch.profiler`` range ``gpubench.<name>`` so that the trace
can name what the host did while the device idled.

A function may belong to a group (``groups``: name -> group): the
group's time is recorded under the group's name, and a call of the group
nested in another (a staging call inside a staging call) counts once, in
the outer one.  The group's time inside the function ``inside`` is also
recorded, as ``<group>_in_<inside>``.
"""

import time
from collections import defaultdict

import torch


class Spans:
    """Wall time per wrapped function, per call of the benchmark's entry.

    ``begin()`` opens a call's record and ``end()`` closes it; ``calls``
    holds one dict per closed call, name -> seconds.
    """

    def __init__(self, groups=None, inside=None):
        self.groups = dict(groups or {})
        self.inside = inside
        self.calls = []
        self._open = None
        self._depth = defaultdict(int)
        self._undo = []

    def begin(self):
        self._open = defaultdict(float)

    def end(self):
        if self._open is not None:
            self.calls.append(dict(self._open))
        self._open = None

    def wrap(self, name, fn):
        """``fn`` timed into the open record under ``name`` (or its group)."""
        group = self.groups.get(name)
        key = group or name
        within = f"{key}_in_{self.inside}"

        def timed(*args, **kwargs):
            outer = self._depth[key] == 0
            self._depth[key] += 1
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(f"gpubench.{name}"):
                    return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                self._depth[key] -= 1
                rec = self._open
                if rec is not None and (outer or group is None):
                    rec[key] += dt
                    if group is not None and self._depth[self.inside]:
                        rec[within] += dt

        return timed

    def install(self, targets):
        """Wrap ``targets``, (module, attribute) pairs, in place: module
        attributes that the program looks up at each call.  Each is
        recorded under the attribute's name."""
        for mod, attr in targets:
            fn = getattr(mod, attr)
            self._undo.append((mod, attr, fn))
            setattr(mod, attr, self.wrap(attr, fn))

    def uninstall(self):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo = []

    def mean_ms(self, key):
        """Mean milliseconds per call of one record key, None without calls."""
        if not self.calls:
            return None
        return 1e3 * sum(c.get(key, 0.0) for c in self.calls) / len(self.calls)
