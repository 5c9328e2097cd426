"""WCS: wall ms per call of the program's span ``host.area`` (the
sidecar read, its parse and the map's launches) over the traced calls;
None where the program has no such span, or where the recorder saw other
calls than the traced ones."""

from gpubench import program_spans

#: the map's host span
SPAN = "host.area"


def read(ctx):
    got = program_spans._read(ctx)
    if got is None or SPAN not in got[0]["spans"]:
        return None
    snap, n = got
    return snap["spans"][SPAN]["total_ms"] / n
