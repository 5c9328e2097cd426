"""PyIMCOM-style consumer of the L2 product's embedded WCS.

Downstream of the reference pipeline, PyIMCOM opens each calibrated L2
file, reads the WCS the pipeline embedded in the product (the reference
ships a gwcs via romanisim ``make_asdf(imwcs=repackage_wcs(thewcs))``,
``src/romanimpreprocess/L1_to_L2/gen_cal_image.py:653-662``), and maps
input pixels onto an output coadd tangent plane — every input sample
that lands in an output postage stamp enters the coaddition system
through exactly two WCS operations (``pixel_to_world`` on the input,
``world_to_pixel`` on the output grid) plus the DQ mask.

This module is that consumer, written against ONLY the product contract
surface: ``roman.meta.wcsinfo`` (flat SIP cards, 0-based CRPIX —
``l1_to_l2.calibrateimage`` embeds them via ``SIPWCS.to_cards``),
``roman.data``, ``roman.err`` / ``var_*``, and ``roman.dq``.  Nothing
here touches pipeline internals, so a PyIMCOM-style client needs
nothing beyond the file.

Host-side numpy by design: a validation/QA tool in the IO layer (one
postage stamp at a time), not a pipeline hot path; the coadd math of a
real coadder (the system-matrix contractions) is out of scope for the
preprocessing framework.
"""

import argparse
import sys

import numpy as np

from ..io import asdf_lite
from ..ops import wcsutils

__all__ = ["L2Image", "CoaddGrid", "resample", "open_l2"]


class L2Image:
    """A calibrated L2 product viewed through its public contract.

    Parameters
    ----------
    tree : dict
        The ASDF tree (``asdf_lite.open(path).tree``-style mapping with
        a ``roman`` branch).
    """

    def __init__(self, tree):
        r = tree["roman"]
        meta = r["meta"]
        if "wcsinfo" not in meta:
            raise ValueError(
                "L2 product carries no meta.wcsinfo (calibrated without "
                "a FITSWCS sidecar); a coadd consumer cannot place it"
            )
        self.meta = meta
        # the embedded cards are 0-based CRPIX by contract
        # (l1_to_l2.calibrateimage: SIPWCS.to_cards + pixel_convention)
        self.wcs = wcsutils.SIPWCS.from_header(meta["wcsinfo"], zero_based=True)
        self.data = np.asarray(r["data"], np.float64)
        self.dq = np.asarray(r["dq"], np.uint32)
        err = r.get("err")
        self.var = (
            np.asarray(err, np.float64) ** 2
            if err is not None
            else np.zeros_like(self.data)
        )

    @property
    def shape(self):
        return self.data.shape


def open_l2(path):
    """Open an L2 ASDF file as an :class:`L2Image`."""
    return L2Image(asdf_lite.open(path))


class CoaddGrid:
    """Output coadd tangent-plane grid (a PyIMCOM block's geometry).

    A plain TAN WCS centered on (``ra``, ``dec``) with north up:
    ``scale`` arcsec/pixel, ``shape`` = (ny, nx), CRPIX at the grid
    center (0-based).
    """

    def __init__(self, ra, dec, scale, shape):
        ny, nx = shape
        s = float(scale) / 3600.0
        self.shape = (int(ny), int(nx))
        # RA increases left in the usual east-left convention
        self.wcs = wcsutils.SIPWCS(
            crpix=[(nx - 1) / 2.0, (ny - 1) / 2.0],
            cd=[[-s, 0.0], [0.0, s]],
            crval=[float(ra), float(dec)],
        )

    def world_grid(self):
        """(ra, dec) of every output pixel center, shape ``self.shape``."""
        ny, nx = self.shape
        X, Y = np.meshgrid(np.arange(nx, dtype=float), np.arange(ny, dtype=float))
        return self.wcs.pix2world(X, Y)


def resample(l2, grid, dq_mask=0xFFFFFFFF):
    """Bilinear-resample an L2 image onto a coadd grid.

    For every output pixel center: output pixel -> world (grid WCS) ->
    input pixel (the L2 product's embedded WCS) -> bilinear combination
    of the 4 surrounding input samples, excluding samples whose
    ``dq & dq_mask`` is nonzero and renormalizing the surviving weights
    (the standard masked-interpolation a coadd input layer applies).

    Returns a dict:

    ``data``
        resampled image (NaN where no unmasked input sample exists),
    ``var``
        propagated variance ``sum(w_i^2 var_i) / (sum w_i)^2``,
    ``coverage``
        sum of unmasked bilinear weights in [0, 1] (0 = off-detector
        or fully masked).
    """
    ra, dec = grid.world_grid()
    x, y = l2.wcs.world2pix(ra, dec)
    ny_in, nx_in = l2.shape

    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = x - x0
    fy = y - y0

    out = np.zeros(grid.shape)
    var = np.zeros(grid.shape)
    wsum = np.zeros(grid.shape)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            inside = (xi >= 0) & (xi < nx_in) & (yi >= 0) & (yi < ny_in)
            xc = np.clip(xi, 0, nx_in - 1)
            yc = np.clip(yi, 0, ny_in - 1)
            good = inside & ((l2.dq[yc, xc] & np.uint32(dq_mask)) == 0)
            w = np.where(good, (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy), 0.0)
            out += w * l2.data[yc, xc]
            var += w**2 * l2.var[yc, xc]
            wsum += w
    with np.errstate(invalid="ignore", divide="ignore"):
        data = np.where(wsum > 0, out / wsum, np.nan)
        var = np.where(wsum > 0, var / np.maximum(wsum, 1e-300) ** 2, np.nan)
    return {"data": data, "var": var, "coverage": wsum}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Resample an L2 product onto a coadd tangent plane "
        "using only the WCS embedded in the file (PyIMCOM-style consumer)."
    )
    p.add_argument("l2file")
    p.add_argument("--ra", type=float, default=None, help="stamp center RA (deg); default: detector center")
    p.add_argument("--dec", type=float, default=None)
    p.add_argument("--scale", type=float, default=0.08, help="output arcsec/pixel")
    p.add_argument("--n", type=int, default=64, help="output stamp side")
    p.add_argument("--out", default=None, help="write the stamp as FITS")
    a = p.parse_args(argv)

    l2 = open_l2(a.l2file)
    if a.ra is None or a.dec is None:
        ny, nx = l2.shape
        ra0, dec0 = l2.wcs.pix2world((nx - 1) / 2.0, (ny - 1) / 2.0)
        a.ra = float(ra0) if a.ra is None else a.ra
        a.dec = float(dec0) if a.dec is None else a.dec
    grid = CoaddGrid(a.ra, a.dec, a.scale, (a.n, a.n))
    res = resample(l2, grid)
    cov = res["coverage"]
    d = res["data"]
    print(
        f"stamp {a.n}x{a.n} @ ({a.ra:.6f}, {a.dec:.6f}) {a.scale}\"/px: "
        f"coverage {float(cov.mean()):.3f}, "
        f"median {float(np.nanmedian(d)):.4f}, "
        f"peak {float(np.nanmax(d)):.4f}"
    )
    if a.out:
        from ..io import fits_lite

        h = fits_lite.Header()
        for k, v in grid.wcs.to_cards().items():
            # FITS convention: 1-based CRPIX
            if k in ("CRPIX1", "CRPIX2"):
                v = v + 1.0
            h[k] = v
        fits_lite.PrimaryHDU(
            data=np.asarray(d, np.float32), header=h
        ).writeto(a.out, overwrite=True)
        print(f"wrote {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
