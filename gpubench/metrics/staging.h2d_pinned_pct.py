"""Staging: share (%) of the copies to the device (``h2d_bytes``) that
went through page-locked host memory (``h2d_pinned_bytes``), over the
traced calls of either entry; None where the program keeps no such
counter, or the recorder saw other calls than the traced ones."""

from gpubench import program_spans

#: the spans that mark one call of either entry: ``calibrate_tree``'s and the lane's
CALL_SPANS = ("host.calibrate", "host.lane")


def read(ctx):
    snap = program_spans.snapshot()
    if not snap:
        return None
    calls = len(ctx.spans.calls) if ctx.spans is not None else 0
    seen = [snap.get("spans", {}).get(k, {}).get("count", 0) for k in CALL_SPANS]
    c = snap.get("counters", {})
    if not calls or calls not in seen or "h2d_pinned_bytes" not in c or not c.get("h2d_bytes"):
        return None
    return 100.0 * c["h2d_pinned_bytes"] / c["h2d_bytes"]
