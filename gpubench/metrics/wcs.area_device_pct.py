"""WCS: share (%) of the pixel-area maps made on a CUDA device, the
program's counter ``area_device`` over ``area_device + area_host``, over
the traced calls; None where the program keeps neither counter, or where
the recorder saw other calls than the traced ones."""

from gpubench import program_spans


def read(ctx):
    got = program_spans._read(ctx)
    if got is None:
        return None
    c = got[0]["counters"]
    dev, host = c.get("area_device", 0), c.get("area_host", 0)
    return 100.0 * dev / (dev + host) if dev + host else None
