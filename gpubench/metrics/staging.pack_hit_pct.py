"""Staging: share (%) of the per-pack lookups of the traced calls that
found the cal pack whole on the device (the program's ``pack_hits`` over
``pack_hits`` + ``pack_misses``).  None where the program counts no such
lookup, or the recorder saw other calls than the traced ones."""

from gpubench import program_spans


def read(ctx):
    got = program_spans._read(ctx)
    if got is None:
        return None
    c = got[0]["counters"]
    hit, miss = c.get("pack_hits", 0), c.get("pack_misses", 0)
    return 100.0 * hit / (hit + miss) if hit + miss else None
