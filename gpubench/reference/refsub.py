"""Reference-pixel subtraction (Laliotis et al. 2024 style).

Re-implements the reference's ``ref_subtraction_row`` /
``ref_subtraction_channel`` (``utils/reference_subtraction.py:16-125``)
with vectorized medians and closed-form line fits.  Both take frames
with any leading batch dimensions (e.g. the group axis) and return new
tensors.

Every median here is numpy's: the mean of the two middle values for an
even count (:func:`median`), not ``torch.median``'s lower one.
"""

import torch


def median(x, dim=None):
    """numpy-style median: for an even count, the mean of the two middle
    values (``torch.median`` returns the lower one).  ``dim=None`` takes
    the median of all elements."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    n = x.shape[dim]
    v = torch.sort(x, dim=dim).values
    lo = v.narrow(dim, (n - 1) // 2, 1).squeeze(dim)
    hi = v.narrow(dim, n // 2, 1).squeeze(dim)
    return (lo + hi) * 0.5


def ref_subtraction_row(image, nside=4096, nborder=4, channelwidth=128,
                        use_ref_channel=False, slope=None):
    """Row-wise reference subtraction on (..., nside, nside[+cw]) frames.

    Per row: median of the active region and median of the reference
    region (left+right border columns, or the amp33 block when
    ``use_ref_channel``).  A straight-line fit of active-median vs
    reference-median gives the coupling slope (unless ``slope`` is
    supplied); ``slope * (ref_median - median(ref_median))`` is
    subtracted from each row.  Reference:
    ``reference_subtraction.py:77-125``.

    The three steps are :func:`row_medians` (local to each row),
    :func:`row_coefs` (over all rows of the frame) and
    :func:`row_apply`, so that a caller holding a slab of the rows can
    gather the medians for the middle one.
    """
    image = image.to(torch.float32)  # raw L1 frames are uint16
    sci_med, ref_med = row_medians(image, nside, nborder, channelwidth,
                                   use_ref_channel)
    m, ctr = row_coefs(sci_med, ref_med, slope)
    return row_apply(image, ref_med, m, ctr)


def row_medians(image, nside=4096, nborder=4, channelwidth=128,
                use_ref_channel=False):
    """(active median, reference median) of every row, (..., ny) each."""
    nb = nborder
    sci_med = median(image[..., nb : nside - nb], dim=-1)
    if use_ref_channel:
        ref_med = median(image[..., nside : nside + channelwidth], dim=-1)
    else:
        ref = torch.cat([image[..., :nb], image[..., nside - nb : nside]], dim=-1)
        ref_med = median(ref, dim=-1)
    return sci_med, ref_med


def row_coefs(sci_med, ref_med, slope=None):
    """(m, ctr), (..., 1) each, from the medians of ALL rows of the
    frame: the closed-form 1-degree least-squares slope of ``sci_med`` on
    ``ref_med`` (or ``slope``) and the median of ``ref_med``."""
    if slope is None:
        rm = ref_med.mean(dim=-1, keepdim=True)
        sm = sci_med.mean(dim=-1, keepdim=True)
        m = ((ref_med - rm) * (sci_med - sm)).sum(dim=-1, keepdim=True) / (
            (ref_med - rm) ** 2
        ).sum(dim=-1, keepdim=True)
    else:
        m = slope
    ctr = median(ref_med, dim=-1)[..., None]
    return m, ctr


def row_apply(image, ref_med, m, ctr):
    """``image`` less ``m * (ref_med - ctr)`` on each of its rows."""
    return image - (m * (ref_med - ctr))[..., None]


def ref_subtraction_channel(image, nside=4096, nborder=4, channelwidth=128,
                            use_ref_channel=False):
    """Channel-wise reference subtraction on (..., ny, nx) frames.

    For each readout channel (width ``channelwidth``; the amp33 block is
    channel 33 when ``use_ref_channel``): medians of the bottom and top
    ``nborder`` rows define a line across the rows, subtracted from
    every pixel of the channel.  Reference:
    ``reference_subtraction.py:16-74``.

    The two steps are :func:`channel_line` (from the frame's edge rows)
    and :func:`channel_apply` (at each row's frame row), so that a
    caller holding a slab of the rows can gather the edge rows.
    """
    image = image.to(torch.float32)
    ny = image.shape[-2]
    nb = nborder
    m, c = channel_line(image[..., :nb, :], image[..., ny - nb :, :], ny, nside,
                        nb, channelwidth, use_ref_channel)
    return channel_apply(image, m, c, channelwidth)


def _nch(nxa, nside, channelwidth, use_ref_channel):
    nch = nxa // channelwidth
    if not use_ref_channel:
        nch = min(nch, nside // channelwidth)
    return nch


def channel_line(bottom, top, ny, nside=4096, nborder=4, channelwidth=128,
                 use_ref_channel=False):
    """(m, c), (..., nch) each: per channel, the line through the medians
    of the frame's ``bottom`` and ``top`` ``nborder`` rows (..., nborder,
    nx) at their mean rows, in a frame of ``ny`` rows."""
    lead = bottom.shape[:-2]
    nch = _nch(bottom.shape[-1], nside, channelwidth, use_ref_channel)
    nb = nborder

    def edge_median(rows):  # (..., nb, nx) -> (..., nch)
        r = rows[..., : nch * channelwidth].reshape(lead + (nb, nch, channelwidth))
        r = r.transpose(-3, -2).reshape(lead + (nch, nb * channelwidth))
        return median(r, dim=-1)

    bot = edge_median(bottom)
    tp = edge_median(top)
    y0 = (nb - 1) / 2.0
    y1 = ny - 1 - (nb - 1) / 2.0
    m = (tp - bot) / (y1 - y0)  # per channel
    c = bot - m * y0
    return m, c


def channel_apply(image, m, c, channelwidth=128, row0=0):
    """``image`` (..., ny, nx), whose first row is the frame's row
    ``row0``, less each channel's line ``m * row + c`` at its frame
    rows; columns beyond the ``m.shape[-1]`` channels pass through."""
    ny = image.shape[-2]
    lead = image.shape[:-2]
    nch = m.shape[-1]
    block = image[..., : nch * channelwidth].reshape(lead + (ny, nch, channelwidth))
    rows = torch.arange(row0, row0 + ny, dtype=image.dtype, device=image.device)
    correction = m[..., None, :] * rows[:, None] + c[..., None, :]  # (..., ny, nch)
    block = block - correction[..., None]
    out = image.clone()
    out[..., : nch * channelwidth] = block.reshape(lead + (ny, nch * channelwidth))
    return out
