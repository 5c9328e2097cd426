"""Staging: GB of device memory the resident cal packs hold at the end of
the traced calls (the program's gauge ``pack_resident_bytes``, a level).
None where the program keeps no such gauge, or the recorder saw other
calls than the traced ones."""

from gpubench import program_spans


def read(ctx):
    got = program_spans._read(ctx)
    if got is None or "pack_resident_bytes" not in got[0].get("gauges", {}):
        return None
    return got[0]["gauges"]["pack_resident_bytes"] / 1e9
