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
    """
    image = image.to(torch.float32)  # raw L1 frames are uint16
    nb = nborder
    sci_med = median(image[..., nb : nside - nb], dim=-1)
    if use_ref_channel:
        ref_med = median(image[..., nside : nside + channelwidth], dim=-1)
    else:
        ref = torch.cat([image[..., :nb], image[..., nside - nb : nside]], dim=-1)
        ref_med = median(ref, dim=-1)

    if slope is None:
        # closed-form 1-degree least squares of sci_med on ref_med
        rm = ref_med.mean(dim=-1, keepdim=True)
        sm = sci_med.mean(dim=-1, keepdim=True)
        m = ((ref_med - rm) * (sci_med - sm)).sum(dim=-1, keepdim=True) / (
            (ref_med - rm) ** 2
        ).sum(dim=-1, keepdim=True)
    else:
        m = slope
    ctr = median(ref_med, dim=-1)[..., None]
    return image - (m * (ref_med - ctr))[..., None]


def ref_subtraction_channel(image, nside=4096, nborder=4, channelwidth=128,
                            use_ref_channel=False):
    """Channel-wise reference subtraction on (..., ny, nx) frames.

    For each readout channel (width ``channelwidth``; the amp33 block is
    channel 33 when ``use_ref_channel``): medians of the bottom and top
    ``nborder`` rows define a line across the rows, subtracted from
    every pixel of the channel.  Reference:
    ``reference_subtraction.py:16-74``.
    """
    image = image.to(torch.float32)
    ny, nxa = image.shape[-2:]
    lead = image.shape[:-2]
    nch = nxa // channelwidth
    if not use_ref_channel:
        nch = min(nch, nside // channelwidth)
    nb = nborder
    block = image[..., : nch * channelwidth].reshape(lead + (ny, nch, channelwidth))

    def edge_median(rows):  # (..., nb, nch, cw) -> (..., nch)
        r = rows.transpose(-3, -2).reshape(lead + (nch, nb * channelwidth))
        return median(r, dim=-1)

    bottom = edge_median(block[..., :nb, :, :])
    top = edge_median(block[..., ny - nb :, :, :])
    y0 = (nb - 1) / 2.0
    y1 = ny - 1 - (nb - 1) / 2.0
    m = (top - bottom) / (y1 - y0)  # per channel
    c = bottom - m * y0
    rows = torch.arange(ny, dtype=image.dtype, device=image.device)
    correction = m[..., None, :] * rows[:, None] + c[..., None, :]  # (..., ny, nch)
    block = block - correction[..., None]
    out = image.clone()
    out[..., : nch * channelwidth] = block.reshape(lead + (ny, nch * channelwidth))
    return out
