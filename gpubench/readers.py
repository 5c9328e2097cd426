"""The per-layer metrics' arithmetic, one function a quantity.

Each file ``metrics/<name>.py`` binds its ``read`` to one of these, so
that a quantity split over cells that report different end-to-end
metrics (``<quantity>`` and ``<quantity>.<suffix>``) is computed once.
``ctx`` carries ``spans`` (:class:`.spans.Spans` of the traced calls),
``dev`` (:class:`.trace.Device`, None off the card), ``kind`` (the
card's name) and ``shapes`` (the entry's sizes: ``ngrp``, ``nside``,
``ncoef`` for ``l1_to_l2``).  Each
returns None where it finds nothing to read.
"""

from . import roofline


def _calls(ctx):
    return ctx.spans is not None and bool(ctx.spans.calls)


def _traced(ctx):
    return ctx.dev is not None and bool(ctx.dev.ncalls)


def host_prepare_ms(ctx):
    """Wall ms of ``prepare_inputs`` per SCA, less the staging inside it."""
    if not _calls(ctx):
        return None
    s = ctx.spans
    return s.mean_ms("prepare_inputs") - s.mean_ms("staging_in_prepare_inputs")


def host_package_ms(ctx):
    """Wall ms of ``to_host`` + ``package_tree`` + ``typefix.fix`` per SCA."""
    if not _calls(ctx):
        return None
    s = ctx.spans
    return s.mean_ms("to_host") + s.mean_ms("package_tree") + s.mean_ms("typefix.fix")


def staging_ms(ctx):
    """Wall ms inside ``stage``, ``ipc_precal`` and ``kernel_planes_frame``
    per SCA, nested calls once."""
    return ctx.spans.mean_ms("staging") if _calls(ctx) else None


def staging_h2d_mb(ctx):
    """Host-to-device MB per SCA from the trace's memcpy records."""
    return ctx.dev.h2d_bytes() / ctx.dev.ncalls / 1e6 if _traced(ctx) else None


def core_device_ms(ctx):
    """Device ms of the operations launched under the program's ranges
    (``l1_to_l2.<stage>``), per SCA."""
    if not _traced(ctx):
        return None
    us = ctx.dev.stage_us()
    return us / ctx.dev.ncalls / 1e3 if us > 0 else None


def device_idle_pct(ctx):
    """Share (%) of the traced window in which no kernel runs."""
    d = ctx.dev
    if d is None or not d.window_us() or d.busy_us() <= 0:
        return None
    return 100.0 * (1.0 - d.busy_us() / d.window_us())


def device_copy_ms(ctx):
    """Device ms of the memcopies and memsets, both ways, per SCA."""
    if not _traced(ctx):
        return None
    us = ctx.dev.copy_us()
    return us / ctx.dev.ncalls / 1e3 if us > 0 else None


def _stage_roofline(ctx, stage, nbytes):
    if not _traced(ctx):
        return None
    us = ctx.dev.stage_us(stage)
    return roofline.roofline_pct(nbytes, us * 1e-6 / ctx.dev.ncalls, ctx.kind)


def linearity_roofline_pct(ctx):
    """The linearity step's share (%) of the bandwidth bound: its least
    bytes at peak over the device time under ``l1_to_l2.linearity``."""
    sh = ctx.shapes
    return _stage_roofline(ctx, "l1_to_l2.linearity", roofline.linearity_bytes(
        sh["ngrp"], sh["nside"], sh["nside"], sh["ncoef"]))


def ipc_roofline_pct(ctx):
    """The IPC inverse's share (%) of the bandwidth bound: its least bytes
    at peak over the device time under ``l1_to_l2.ipc``."""
    sh = ctx.shapes
    return _stage_roofline(ctx, "l1_to_l2.ipc", roofline.ipc_bytes(sh["ngrp"], sh["nside"]))
