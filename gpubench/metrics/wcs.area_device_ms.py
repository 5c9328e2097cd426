"""WCS: device ms per call under the program's range ``l1_to_l2.area``
(the pixel-area map made on the card) over the traced calls; None off
the card, where the program has no such range, or where the recorder saw
other calls than the traced ones."""

from gpubench import program_spans

#: the map's device range
RANGE = "l1_to_l2.area"


def read(ctx):
    if ctx.dev is None or not ctx.dev.ncalls or program_spans._read(ctx) is None:
        return None
    us = ctx.dev.stage_us(RANGE)
    return us / ctx.dev.ncalls / 1e3 if us > 0 else None
