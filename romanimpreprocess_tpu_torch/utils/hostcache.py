"""Bounded, thread-safe host-side caches.

Several host paths memoize expensive per-cal-pack work: the IPC-precal
planes, the median gain and WCS sidecars (:mod:`..pipeline.l1_to_l2`),
the border-zeroed IPC kernel planes (:mod:`..ops.ipc_cuda`), loaded CalPacks
(:mod:`..io.calfiles`).  They share subtle requirements — safe to call
from several threads, evict-oldest without
clearing live entries, and (for id-keyed caches) strong references to
the keyed objects held in the value so a GC'd array can't alias a
recycled ``id``.  One implementation here so a concurrency fix can't
miss a copy.  Each cache is named, and counts its lookups as
``cache.<name>.hit`` / ``cache.<name>.miss`` (:func:`.profiling.count`,
while a profiler records).
"""

import threading

from . import profiling

_MISSING = object()


class BoundedCache:
    """Insertion-ordered mapping with locked reads and evict-oldest
    inserts.

    ``get`` and ``put`` take one lock, so the focal-plane drivers' pool
    threads (:mod:`..parallel`) never read a half-evicted mapping;
    ``put`` evicts the oldest entries down to ``capacity`` and returns
    the inserted value — callers must use that return rather than
    re-reading the cache, which another thread's eviction may already
    have emptied.
    """

    def __init__(self, capacity, name):
        self.capacity = int(capacity)
        self._hit, self._miss = f"cache.{name}.hit", f"cache.{name}.miss"
        self._d = {}
        self._lock = threading.Lock()

    def get(self, key, default=None):
        with self._lock:
            v = self._d.get(key, _MISSING)
        if v is _MISSING:
            profiling.count(self._miss)
            return default
        profiling.count(self._hit)
        return v

    def put(self, key, value):
        with self._lock:
            while self._d and len(self._d) >= self.capacity:
                self._d.pop(next(iter(self._d)))
            self._d[key] = value
        return value

    def clear(self):
        with self._lock:
            self._d.clear()

    def __len__(self):
        with self._lock:
            return len(self._d)
