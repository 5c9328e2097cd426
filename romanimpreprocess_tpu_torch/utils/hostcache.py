"""Bounded, thread-safe host-side caches.

Several host paths memoize expensive per-cal-pack work: the median gain
and WCS sidecars (:mod:`..pipeline.l1_to_l2`), the pre-padded IPC kernel
planes (:mod:`..ops.ipc_slab`), loaded CalPacks (:mod:`..io.calfiles`)
in a :class:`BoundedCache`; the device copies of cal packs, with their
IPC precal and kernel planes (:mod:`..io.staging`), in a
:class:`PackCache`.  They share subtle requirements — safe to call from
several threads, eviction without clearing live entries, and (for
id-keyed caches) strong references to the keyed objects held in the
value so a GC'd array can't alias a recycled ``id``.  One implementation
here so a concurrency fix can't miss a copy.  Each cache is named, and
counts its lookups as ``cache.<name>.hit`` / ``cache.<name>.miss``
(:func:`.profiling.count`, while a profiler records).
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

    def pop(self, key, default=None):
        with self._lock:
            return self._d.pop(key, default)

    def items(self):
        """The entries, oldest first (a copy)."""
        with self._lock:
            return list(self._d.items())

    def values(self):
        with self._lock:
            return list(self._d.values())

    def clear(self):
        with self._lock:
            self._d.clear()

    def __len__(self):
        with self._lock:
            return len(self._d)


#: packs a :class:`PackCache` holds at most, on all devices: more than a
#: focal plane's 18; the bound where no budget bounds the bytes (the CPU,
#: where resident packs keep their host arrays alive)
MAX_PACKS = 25


class _Pack:
    """A cal pack's entries on one device, ``key -> (value, nbytes)``:
    pending while its lookup is open, then resident."""

    __slots__ = ("key", "keep", "device", "entries", "nbytes")

    def __init__(self, key, keep, device):
        self.key, self.keep, self.device = key, keep, device
        self.entries, self.nbytes = {}, 0


class PackCache:
    """Device copies of cal packs, held whole under a byte budget.

    Entries are keyed as :class:`BoundedCache`'s (by ``id`` and device;
    the value holds the keyed host objects).  :meth:`pack` opens a cal
    pack's lookup on a device; :meth:`get` and :meth:`put` with it look
    up and add the pack's entries, and :meth:`admit` closes it: the new
    entries join what the pack holds all together, or the pack is not
    resident at all.  Evictions drop whole packs.  An entry put without a
    pack (an array staged outside one) is loose, kept in :attr:`loose`
    (a :class:`BoundedCache` of ``capacity``); a pack's lookup that finds
    a loose entry takes it into the pack.

    ``budget`` bounds the bytes the cache holds on a device, loose and
    packs: a number, or ``budget(device, held)`` of the bytes held there
    (new ones included), None for no bound; at most :data:`MAX_PACKS`
    packs are resident (past it, the least recently looked up goes).
    Each :meth:`admit` (and each loose :meth:`put`) keeps to the budget: room is made from the device's loose entries (oldest
    first), then, for a pack, from packs not looked up since this pack
    last was (least recently first); where that does not make room, the
    pack is not resident at all and a loose entry is not kept.  A pack
    seen for the first time evicts no pack.  So under a cyclic rotation
    of more packs than fit, the resident ones stay and each hits once a
    round (a policy that evicted to admit every miss would hit almost
    never), and packs a job has stopped using give way to new ones that
    come back.
    """

    def __init__(self, name, capacity=64, budget=None):
        self.loose = BoundedCache(capacity, name)  # key -> (value, nbytes, device)
        self._budget = budget
        self._hit = f"cache.{name}.hit"
        self._lock = threading.Lock()
        self._packs = {}  # pack key -> resident _Pack
        self._home = {}  # entry key -> the key of the pack holding it
        self._seen = {}  # pack key -> tick of its last lookup, oldest first
        self._tick = 0

    @property
    def resident_bytes(self):
        """Bytes the resident packs hold, on every device."""
        with self._lock:
            return sum(p.nbytes for p in self._packs.values())

    def pack(self, obj, device):
        """Open the lookup of the cal pack ``obj`` on ``device`` (kept
        strongly while resident); close it with :meth:`admit`."""
        return _Pack((id(obj), str(device)), obj, str(device))

    def get(self, key, default=None, pack=None):
        """The value of ``key``, held by a pack or loose, else ``default``;
        with ``pack``, also among its new entries."""
        with self._lock:
            pk = self._home.get(key)
            v = (self._packs[pk].entries[key] if pk is not None
                 else pack.entries.get(key) if pack is not None else None)
            if v is None:  # the loose cache counts the lookup
                v = self.loose.get(key)
                if v is None:
                    return default
                if pack is not None:  # joins the pack
                    self.loose.pop(key)
                    pack.entries[key] = v[:2]
                return v[0]
        profiling.count(self._hit)
        return v[0]

    def put(self, key, value, nbytes=0, device=None, pack=None):
        """Add ``value`` (``nbytes`` on ``device``) to ``pack``, or as a
        loose entry where it fits; returns ``value``."""
        if pack is not None:
            pack.entries[key] = (value, int(nbytes))
            return value
        device = str(device)
        with self._lock:
            self.loose.pop(key)
            if self._make_room(device, int(nbytes)) is not None:
                self.loose.put(key, (value, int(nbytes), device))
        return value

    def admit(self, pack):
        """Close the lookup of ``pack``.  True where every lookup made with
        it hit (``pack_hits``; else ``pack_misses``).  Sets the gauge
        ``pack_resident_bytes``; an eviction counts ``pack_evictions``,
        inside the span ``host.pack_evict``."""
        hit = not pack.entries
        with self._lock:
            self._tick += 1
            prev = self._seen.pop(pack.key, None)
            self._seen[pack.key] = self._tick
            held = self._packs.get(pack.key)
            new = {k: e for k, e in pack.entries.items() if k not in self._home}
            dropped = self._make_room(pack.device, sum(nb for _, nb in new.values()),
                                      pack.key, prev)
            if dropped is None:  # no room: not resident at all
                dropped = [self._drop(pack.key)] if held is not None else []
            elif new:
                if held is None:
                    held = self._packs[pack.key] = _Pack(pack.key, pack.keep, pack.device)
                for k, e in new.items():
                    held.entries[k] = e
                    held.nbytes += e[1]
                    self._home[k] = pack.key
            # a lookup older than every resident pack's can evict none
            oldest = min((self._seen[k] for k in self._packs), default=self._tick)
            for k in [k for k, t in self._seen.items() if t < oldest]:
                del self._seen[k]
            resident = sum(p.nbytes for p in self._packs.values())
        profiling.count("pack_hits" if hit else "pack_misses")
        if dropped:
            with profiling.span("host.pack_evict"):
                profiling.count("pack_evictions", len(dropped))
                del dropped[:]
        profiling.gauge("pack_resident_bytes", resident)
        return hit

    def _make_room(self, device, add, key=None, prev=None):
        """Under the lock: evict so that ``add`` more bytes fit on
        ``device`` (and, for the pack ``key``, one more pack); the packs
        evicted, or None (nothing evicted) where that makes no room."""
        held = add + sum(e[1] for e in self.loose.values() if e[2] == device) + sum(
            p.nbytes for p in self._packs.values() if p.device == device)
        budget = self._budget(device, held) if callable(self._budget) else self._budget
        over = 0 if budget is None else held - budget
        count = 0 if key is None else len(self._packs) + (key not in self._packs) - MAX_PACKS
        loose, packs = [], []
        for k, e in self.loose.items():
            if over <= 0:
                break
            if e[2] == device:
                loose.append(k)
                over -= e[1]
        for k, t in self._seen.items() if key is not None else ():  # oldest lookup first
            if count <= 0 and (over <= 0 or prev is None or t > prev):
                break
            p = self._packs.get(k)
            if p is None or k == key or (count <= 0 and p.device != device):
                continue
            packs.append(k)
            count -= 1
            over -= p.nbytes if p.device == device else 0
        if over > 0 or count > 0:
            return None
        for k in loose:
            self.loose.pop(k)
        return [self._drop(k) for k in packs]

    def _drop(self, pk):
        p = self._packs.pop(pk)
        for k in p.entries:
            del self._home[k]
        return p

    def clear(self):
        """Drop every entry, loose and resident, on every device."""
        with self._lock:
            dropped, self._packs, self._home, self._seen = self._packs, {}, {}, {}
            self.loose.clear()
        del dropped
        profiling.gauge("pack_resident_bytes", 0)

    def __len__(self):
        with self._lock:
            return len(self.loose) + len(self._home)
