"""Pixel-mask reference-file production.

Equivalent of the reference's ``makemask.py`` (``runs/summer2025run``,
plus the 2026_July gain-dq variant): flags

- the 4-pixel reference border (REFERENCE_PIXEL, bit 31),
- low-QE pixels (pflat < 0.5 of its median, bit 13),
- hot (> 12.5 DN/s, bit 11) and warm (> 0.25 DN/s, bit 12) pixels from
  the dark slope,
- plus the linearity dq, and optionally the gain dq.
"""

import numpy as np

from .. import pars
from ..config import resolve_device
from . import add_device_argument, ref_meta
from ..dqflags import pixel
from ..io import asdf_lite

HOT_THRESHOLD = 12.5  # DN/s
WARM_THRESHOLD = 0.25  # DN/s
LOW_QE_FRACTION = 0.5


def make_mask_file(out_path, sca, lin_file, dark_file, gain_file=None,
                   nside=None):
    nside = nside or pars.nside
    nb = pars.nborder
    dq = np.zeros((nside, nside), dtype=np.uint32)

    dq[:nb, :] |= np.uint32(pixel.REFERENCE_PIXEL)
    dq[-nb:, :] |= np.uint32(pixel.REFERENCE_PIXEL)
    dq[:, :nb] |= np.uint32(pixel.REFERENCE_PIXEL)
    dq[:, -nb:] |= np.uint32(pixel.REFERENCE_PIXEL)

    lin = asdf_lite.open(lin_file)["roman"]
    pflat = np.asarray(lin["pflat"])
    if pflat.ndim == 3:
        pflat = pflat[0]
    pflat = pflat / np.median(pflat)
    dq |= np.asarray(lin["dq"], np.uint32)
    dq |= np.where(
        pflat < LOW_QE_FRACTION, np.uint32(pixel.LOW_QE), np.uint32(0)
    )

    darkslope = np.asarray(asdf_lite.open(dark_file)["roman"]["dark_slope"])
    dq |= np.where(
        darkslope > WARM_THRESHOLD,
        np.where(darkslope > HOT_THRESHOLD, np.uint32(pixel.HOT),
                 np.uint32(pixel.WARM)),
        np.uint32(0),
    ).astype(np.uint32)

    if gain_file is not None:  # 2026_July variant: OR the gain dq
        dq |= np.asarray(asdf_lite.open(gain_file)["roman"]["dq"], np.uint32)

    asdf_lite.AsdfFile(
        {
            "roman": {
                "meta": ref_meta("MASK", sca, "calib.makemask"),
                "dq": dq,
            }
        }
    ).write_to(out_path)
    return out_path


def main(argv=None):
    """``makemask <outfile> <sca>`` — the reference's ``makemask.py``
    CLI: the linearity/dark/gain inputs are derived from the output
    name by the ``_mask_`` substitution; pass ``--no-gain-dq`` for the
    summer-2025 behavior (2026_July ORs the gain dq in)."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("outfile", help="mask output path (contains '_mask_')")
    p.add_argument("sca", type=int)
    p.add_argument("--no-gain-dq", action="store_true")
    p.add_argument("--nside", type=int, default=None)
    add_device_argument(p)
    a = p.parse_args(argv)
    resolve_device(a.device)  # host code: checked as in every calib CLI

    if "_mask_" not in a.outfile:
        p.error("output name must contain '_mask_'")
    sub = a.outfile.replace
    out = make_mask_file(
        a.outfile, a.sca,
        sub("_mask_", "_linearitylegendre_"),
        sub("_mask_", "_dark_"),
        gain_file=None if a.no_gain_dq else sub("_mask_", "_gain_"),
        nside=a.nside,
    )
    print(">>", out)
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
