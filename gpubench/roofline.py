"""Peaks of the card and the least bytes of the measured steps.

The byte counts are frozen copies of the port's ``bytes_moved``
functions (``ops/linearity_cuda.py`` and ``ops/ipc_cuda.py``, commit
30ea5db): each input byte read once, each output byte written once,
at the shapes of the step whatever implements it.
"""

#: published peaks of one card (data sheet, SXM part, dense), by the
#: name ``torch.cuda.get_device_name`` gives
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12,
                              "fp32_flops": 67e12},
}


def peak(kind, key):
    """The peak ``key`` of the card ``kind``; None for a card not listed."""
    return PEAKS.get(kind, {}).get(key)


def linearity_bytes(ngrp, ny, nx, ncoef):
    """The linearity step on a (ngrp, ny, nx) cube: the cube, the
    coefficients, smin / smax / sref / dq and the attempt mask (one
    byte a value) read once; the cube and the DQ plane written once."""
    npix = ny * nx
    return npix * (4 * ngrp + 4 * ncoef + 16 + ngrp + 4 * ngrp + 4)


def ipc_bytes(ngrp, nside):
    """The order-2 IPC inverse on the (ngrp, nside, nside) frame: the
    cube, nine kernel planes and the gain read once, the cube written
    once."""
    return 4 * nside * nside * (2 * ngrp + 9 + 1)


def roofline_pct(nbytes, seconds, kind):
    """Share (%) of the card's bandwidth bound: ``nbytes`` at peak over
    ``seconds``; None where the card or the time is unknown."""
    bw = peak(kind, "hbm_bytes_per_s")
    if not bw or not seconds:
        return None
    return 100.0 * (nbytes / bw) / seconds
