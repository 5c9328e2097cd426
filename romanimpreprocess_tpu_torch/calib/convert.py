"""Raw test-data conversion: per-frame FITS -> ramp-cube FITS.

Equivalent of the reference's ``convert_dark.py`` / ``convert_flt.py`` /
``convert_loflt.py`` (``runs/summer2025run``): collects the N per-frame
full-frame images of one exposure into a (1, N, 4096, 4224) uint16 cube
(science area + amp33), flips from the Detector frame to the Science
frame by SCA row, and appends unweighted slope images (full ramp and
first half, first frame dropped) in DN/frame.
"""

import datetime

import numpy as np

from ..config import resolve_device
from ..io import fits_lite
from . import add_device_argument


def detector_to_science(cube, sca):
    """Flip a (..., ny, nx_aug) cube from Detector to Science frame.

    SCAs in the 3n row flip horizontally (science columns only; the
    amp33 block is not mirrored), others flip vertically.
    """
    n = cube.shape[-2]  # science area is n x n; trailing columns = amp33
    out = cube.copy()
    if sca % 3 == 0:
        out[..., :, :n] = out[..., :, n - 1 :: -1]
    else:
        out = out[..., ::-1, :]
    return out


def unweighted_slopes(cube):
    """(2, ny, nx) slope images in DN/frame: full ramp and first half,
    both excluding frame 0 (centered unweighted least squares)."""
    nframes = cube.shape[0]
    ny, nx = cube.shape[-2:]
    slp = np.zeros((2, ny, nx), dtype=np.float64)
    for count, kmax in ((0, nframes), (1, nframes // 2)):
        den = 0.0
        ctr = kmax / 2.0
        for k in range(1, kmax):
            slp[count] += cube[k].astype(np.float64) * (k - ctr)
            den += (k - ctr) ** 2
        if den > 0:  # degenerate for very short ramps (kmax <= 2)
            slp[count] /= den
    return slp.astype(np.float32)


def group_exposures(files, nframes=None, exp_re=r"exp(\d+)_"):
    """Group per-frame FITS paths into exposures, in time order.

    The raw test-campaign convention (reference ``convert_dark.py:23-48``)
    names frames ``..._exp{j}_...SCU{sca}...{frame-id}.fits``; the frame
    id of a science frame ends in a hex character, while guide-window
    interleaves do not and are dropped.  Returns a list of
    (exposure_number, [files...]) sorted by exposure number, keeping
    only groups with at least ``nframes`` frames (and truncating each
    group to the first ``nframes`` when given, as the reference's
    converters do with their N argument).
    """
    import re

    groups = {}
    for f in sorted(files):
        name = f.split("/")[-1]
        if not re.search(r"[0-9A-Fa-f]\.fits$", name):
            continue  # guide-window file
        m = re.search(exp_re, name)
        if m is None:
            continue
        groups.setdefault(int(m.group(1)), []).append(f)
    out = []
    for j in sorted(groups):
        g = groups[j]
        if nframes is not None:
            if len(g) < nframes:
                continue
            g = g[:nframes]
        out.append((j, g))
    return out


def convert_exposure(frame_files, out_path, sca, frame_time=3.04, flip=True):
    """Merge one exposure's per-frame FITS files into the ramp-cube FITS.

    ``frame_files`` are paths to single-frame (4096, 4224) images in
    time order.  Output: primary (TGROUP) + cube HDU (1, N, 4096, 4224)
    + slope HDU, matching the solid-waffle FORMAT 6 layout the
    reference's converters produce.
    """
    n = len(frame_files)
    cube = None
    dates = []
    for k, path in enumerate(frame_files):
        hdus = fits_lite.open_fits(path)
        if cube is None:
            cube = np.zeros((n,) + hdus[0].data.shape, dtype=np.uint16)
        cube[k] = hdus[0].data
        dates.append(str(hdus[0].header.get("DATE", "")))

    if flip:
        cube = detector_to_science(cube, sca)
    slp = unweighted_slopes(cube)

    hdr = fits_lite.Header()
    hdr["PROVEN"] = "romanimpreprocess_tpu_torch.calib.convert"
    hdr["NMAX"] = n
    hdr["DATE"] = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    for k, (path, date) in enumerate(zip(frame_files, dates)):
        hdr[f"FR{k + 1:03d}"] = path.split("/")[-1][:60]
        if date:
            hdr[f"FRD{k + 1:03d}"] = date[:60]
    hdr2 = fits_lite.Header()
    hdr2["BUNIT"] = "DN/frame"
    prim = fits_lite.PrimaryHDU()
    prim.header["TGROUP"] = frame_time
    fits_lite.HDUList(
        [
            prim,
            fits_lite.HDU(cube[None], header=hdr),
            fits_lite.HDU(slp, header=hdr2),
        ]
    ).writeto(out_path, overwrite=True)
    return out_path


# -- CLI ------------------------------------------------------------------

#: test-campaign input prefix and output label per converter kind
#: (reference convert_dark.py:24/79, convert_flt.py:24/82,
#: convert_loflt.py:23/82)
KINDS = {
    "dark": ("Total_Noise_exp", "Noise"),
    "flt": ("linearity_exp", "Flat"),
    "loflt": ("Gain_exp", "LoFlat"),
}


def main(argv=None):
    """``convert {dark,flt,loflt} <indir> <nframes> <outdir> <sca>`` —
    the reference's three converter scripts behind one entry point."""
    import argparse
    import glob as _glob

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("kind", choices=sorted(KINDS))
    p.add_argument("indir")
    p.add_argument("nframes", type=int)
    p.add_argument("outdir")
    p.add_argument("sca", type=int)
    p.add_argument("--frame-time", type=float, default=3.04)
    p.add_argument("--no-flip", action="store_true",
                   help="keep the Detector frame (skip the SCA flip)")
    add_device_argument(p)
    a = p.parse_args(argv)
    resolve_device(a.device)  # host code: checked as in every calib CLI

    prefix, label = KINDS[a.kind]
    files = _glob.glob(f"{a.indir}/{prefix}*SCU{a.sca:02d}*.fits")
    n_out = 0
    for j, frames in group_exposures(files, nframes=a.nframes):
        out = f"{a.outdir}/99999999_SCA{a.sca:02d}_{label}_{j:03d}.fits"
        convert_exposure(frames, out, a.sca, frame_time=a.frame_time,
                         flip=not a.no_flip)
        print(">>", out)
        n_out += 1
    if n_out == 0:
        print(f"no complete {a.kind} exposures found under {a.indir}")
        return 1
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
