"""Staging: MB of cal-pack state copied to the device per SCA (the
program's ``pack_staged_bytes``: its cached arrays, IPC precal and kernel
planes, on a miss) over the traced calls; 0 where the program keeps the
counter and no pack missed.  None where the program keeps no pack
counters (no ``pack_resident_bytes`` gauge), or the recorder saw other
calls than the traced ones."""

from gpubench import program_spans


def read(ctx):
    got = program_spans._read(ctx)
    if got is None or "pack_resident_bytes" not in got[0].get("gauges", {}):
        return None
    snap, n = got
    return snap["counters"].get("pack_staged_bytes", 0) / n / 1e6
