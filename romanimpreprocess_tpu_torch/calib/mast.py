"""MAST / TVAC input handling (the reference's 2026_July variants).

Equivalent of ``runs/2026_July/mapping.pl`` + the solid-waffle
``asdf_to_fits`` call it shells out to: converts Roman uncal ASDF files
(``roman.data`` ramp cube + ``roman.amp33``) into the augmented-frame
FITS ramp cubes the calibration converters and solid-waffle consume,
and maps a MAST download manifest onto per-SCA exposure numbering.

TVAC timing defaults (FORMAT 1, TSTART 3, TFRAME 3.15625 s) are
exposed for the solid-waffle config emitters (``calib.swconfig``).
"""

import os
import re

import numpy as np

from .. import pars
from ..io import asdf_lite, fits_lite

TVAC_FRAME_TIME = 3.15625  # seconds (reference 2026_July configs)
TVAC_FORMAT = 1
TVAC_TSTART = 3


def uncal_asdf_to_fits(in_path, out_path, frame_time=TVAC_FRAME_TIME):
    """One uncal ASDF -> augmented-frame ramp-cube FITS.

    The science cube and the amp33 reference output are packed side by
    side into (1, N, nside, nside_augmented) uint16, the layout the
    converters/solid-waffle expect.
    """
    roman = asdf_lite.open(in_path)["roman"]
    data = np.asarray(roman["data"])
    if data.ndim == 4:
        data = data[0]
    nframes, ny, nx = data.shape
    cw = pars.nside_augmented - pars.nside
    aug = np.zeros((1, nframes, ny, nx + cw), dtype=np.uint16)
    aug[0, :, :, :nx] = data
    if "amp33" in roman:
        a33 = np.asarray(roman["amp33"])
        if a33.ndim == 4:
            a33 = a33[0]
        aug[0, :, :, nx : nx + a33.shape[-1]] = a33

    prim = fits_lite.PrimaryHDU()
    prim.header["TGROUP"] = frame_time
    h = fits_lite.Header()
    h["PROVEN"] = "romanimpreprocess_tpu_torch.calib.mast"
    h["SRC"] = os.path.basename(in_path)[:60]
    fits_lite.HDUList([prim, fits_lite.HDU(aug, header=h)]).writeto(
        out_path, overwrite=True
    )
    return out_path


def map_downloads(manifest_path, sca, input_dir, output_dir, kind="Noise",
                  frame_time=TVAC_FRAME_TIME):
    """Convert a MAST download manifest's uncal files for one SCA.

    Each line of the manifest names (last whitespace field) an uncal
    ASDF; files matching ``WFI{sca:02d}_uncal.asdf`` are converted to
    ``99999999_SCA{sca:02d}_{kind}_{e:03d}.fits`` in exposure order.
    Returns the list of output paths.
    """
    with open(manifest_path) as f:
        names = [line.split()[-1] for line in f if line.strip()]
    names.sort()
    pat = re.compile(rf"WFI{sca:02d}_uncal\.asdf$")
    out = []
    e = 0
    for name in names:
        if not pat.search(name):
            continue
        e += 1
        dst = os.path.join(
            output_dir, f"99999999_SCA{sca:02d}_{kind}_{e:03d}.fits"
        )
        uncal_asdf_to_fits(
            os.path.join(input_dir, os.path.basename(name)), dst,
            frame_time=frame_time,
        )
        out.append(dst)
    return out
