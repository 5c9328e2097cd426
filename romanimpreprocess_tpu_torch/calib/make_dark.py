"""Dark and read-noise reference-file production.

Equivalent of the reference's ``make_dark_file.py``
(``runs/summer2025run/make_dark_file.py:1-210``): from a set of
converted dark-exposure ramp cubes plus the solid-waffle noise summary,
builds

- the ``dark`` file: 3-sigma-clipped group-averaged dark cube (DN),
  dark-current slope map (hi/lo switch at 200 DN/s) and its error,
- the ``read`` file: single-read noise (CDS/sqrt(2)), reset noise,
  1/f amplitudes (ACN/C_PINK/U_PINK) and amp33 reference-output stats.

The sigma-clipped stack over the exposure axis (the reference's ~7 GB
host loop) runs on a torch device, one group's stack at a time.
"""

import numpy as np
import torch

from .. import pars
from ..config import reads_to_pattern, resolve_device
from ..io import asdf_lite, fits_lite
from . import add_device_argument

#: pixels per chunk of :func:`sigma_clip_mean` (a 100-frame chunk's
#: sorted copy, masks and temporaries then take about 2 GB)
CLIP_CHUNK_PIXELS = 1 << 20


def _clip_chunk(stack, sigma, iters):
    """:func:`sigma_clip_mean` on an (n_exp, npix) chunk: (mean, count)."""
    n_exp = stack.shape[0]
    ss = torch.sort(stack, dim=0).values  # NaNs sort last
    idx = torch.arange(n_exp, device=stack.device)[:, None]
    lo = torch.zeros(stack.shape[1:], dtype=torch.int64, device=stack.device)
    hi = n_exp - torch.isnan(ss).sum(dim=0)
    zero = torch.zeros((), dtype=ss.dtype, device=ss.device)

    def at(i):
        return torch.gather(ss, 0, i[None])[0]

    for _ in range(iters):
        good = (idx >= lo) & (idx < hi)
        n = torch.clamp(hi - lo, min=1)
        med = 0.5 * (at(lo + (n - 1) // 2) + at(lo + n // 2))
        mean = torch.where(good, ss, zero).sum(dim=0) / n
        var = torch.where(good, (ss - mean) ** 2, zero).sum(dim=0) / n
        std = torch.sqrt(var)
        # survivors: med - sigma*std <= value <= med + sigma*std
        # (astropy masks strict-outside); bounds only ever tighten
        lo2 = ((idx < hi) & (ss < med - sigma * std)).sum(dim=0)
        hi2 = hi - (good & (ss > med + sigma * std)).sum(dim=0)
        lo, hi = torch.maximum(lo, lo2), torch.minimum(hi, hi2)
    good = (idx >= lo) & (idx < hi)
    n = torch.clamp(hi - lo, min=1)
    return torch.where(good, ss, zero).sum(dim=0) / n, hi - lo


def sigma_clip_mean(stack, sigma=3.0, iters=5, counts=False):
    """Mean over axis 0 with iterative MEDIAN-centered sigma clipping,
    matching ``astropy.stats.sigma_clip(..., sigma=3, axis=0)`` +
    ``nanmean`` as the reference uses it (``make_dark_file.py:69``):
    astropy's default ``cenfunc`` is the median and its ``stdfunc`` the
    ddof=0 std.

    ``stack``: an (n_exp, ...) float32 tensor; the result lies on its
    device.  Values are sorted once along axis 0 (clipping changes only
    the membership), so the survivors of every median-centered clip are
    a contiguous index range [lo, hi) per pixel and each iteration
    tightens the two bounds; the median reads its two order statistics
    with ``torch.gather``.  NaNs sort last and start outside [lo, hi),
    which gives the nanmean.  Pixels are clipped in chunks of
    :data:`CLIP_CHUNK_PIXELS`, so the working set stays near one chunk's.
    ``counts=True`` also returns the survivor counts ``hi - lo`` (int64).
    """
    n_exp = stack.shape[0]
    shape = stack.shape[1:]
    flat = stack.reshape(n_exp, -1)
    npix = flat.shape[1]
    mean = torch.empty(npix, dtype=stack.dtype, device=stack.device)
    count = torch.empty(npix, dtype=torch.int64, device=stack.device)
    for p0 in range(0, npix, CLIP_CHUNK_PIXELS):
        sl = slice(p0, p0 + CLIP_CHUNK_PIXELS)
        mean[sl], count[sl] = _clip_chunk(flat[:, sl], sigma, iters)
    mean, count = mean.reshape(shape), count.reshape(shape)
    return (mean, count) if counts else mean


def _ref_meta(reftype, sca, pattern_name="", ngroups=0):
    from . import ref_meta

    return ref_meta(
        reftype, sca, f"calib.make_dark ({reftype})",
        exposure={
            "groupgap": 0,
            "ma_table_name": pattern_name,
            "ma_table_number": 1000000,
            "nframes": 1,
            "ngroups": ngroups,
            "p_exptype": "WFI_IMAGE|",
            "type": "WFI_IMAGE",
        },
    )


def group_average_darks(noise_files, read_pattern, device=None):
    """Sigma-clipped group-averaged dark cube from converted dark ramps.

    ``noise_files``: paths of convert_exposure outputs (cube in HDU 1).
    Returns (ngrp, ny, nx_aug) float32 (host); the clip runs on
    ``device`` (default ``cuda``).

    Memory stays bounded at one (nfiles, ny, nx_aug) group stack (the
    reference's "~7 GB for 100 darks" note, ``make_dark_file.py:62-64``)
    while IO stays one pass: the files are opened memory-mapped, so the
    group-outer loop reads only each group's pages — an eager reader
    here would re-read every multi-GB ramp once per group.
    """
    dev = resolve_device(device)
    ngrp = len(read_pattern)
    opened = [fits_lite.open_fits(p, memmap=True) for p in noise_files]
    darkave = None
    for ig in range(ngrp):
        lo, hi = read_pattern[ig][0], read_pattern[ig][-1] + 1
        stack = []
        for hdus in opened:
            grp = hdus[1].data[0, lo:hi]  # decodes just these reads
            stack.append(grp.astype(np.float32).mean(axis=0))
        stack = torch.from_numpy(np.stack(stack)).to(dev)
        avg = sigma_clip_mean(stack).cpu().numpy()
        del stack
        if darkave is None:
            darkave = np.zeros((ngrp,) + avg.shape, dtype=np.float32)
        darkave[ig] = avg
    return darkave


def make_dark_and_read_files(pattern_name, reads, noise_files,
                             noise_summary_file, sca, outfile,
                             nside=None, device=None):
    """Build the dark + read ASDF reference files.

    ``noise_summary_file`` is a solid-waffle noise-run FITS whose HDU 1
    header indexes the analysis planes (DARK1/DARK1ERR/DARK2/DARK2ERR/
    CDS/RESET, plus ACN/C_PINK/U_PINK noise amplitudes) and which may
    carry an AMP33 extension (med/std planes + M_PINK/RU_PINK header).
    Returns (dark_path, read_path).  The clip runs on ``device``
    (default ``cuda``).
    """
    nside = nside or pars.nside
    read_pattern = reads_to_pattern(reads)
    ngrp = len(read_pattern)

    darkave = group_average_darks(noise_files, read_pattern, device=device)

    hdus = fits_lite.open_fits(noise_summary_file)
    h = hdus[1].header
    planes = hdus[1].data

    def plane(idx_key):
        return planes[int(h[idx_key]), :, :nside].astype(np.float32)

    dark1 = plane("DARK1")
    dark1e = plane("DARK1ERR")
    dark2 = plane("DARK2")
    dark2e = plane("DARK2ERR")
    use1 = dark2 > 200.0  # switch to the short-baseline fit when bright
    dark_slope = np.where(use1, dark1, dark2).astype(np.float32)
    dark_slope_err = np.where(use1, dark1e, dark2e).astype(np.float32)

    cw = max(nside // pars.nchannel, 4)
    amp33 = {
        "valid": False,
        "med": np.zeros((nside, cw), np.float32),
        "std": np.zeros((nside, cw), np.float32),
        "M_PINK": 0.0,
        "RU_PINK": 0.0,
    }
    for hdu in hdus[2:]:
        if str(hdu.header.get("EXTNAME", "")).strip() == "AMP33":
            amp33 = {
                "valid": True,
                "med": hdu.data[0].astype(np.float32),
                "std": hdu.data[1].astype(np.float32),
                "M_PINK": float(hdu.header["M_PINK"]),
                "RU_PINK": float(hdu.header["RU_PINK"]),
            }

    dark_tree = {
        "roman": {
            "meta": _ref_meta("DARK", sca, pattern_name, ngrp),
            "data": darkave[:, :, :nside].astype(np.float32),
            "dq": np.zeros((nside, nside), np.uint32),
            "dark_slope": dark_slope,
            "dark_slope_err": dark_slope_err,
        },
        "notes": {"noise_header": h.tostring(padding=False)},
    }
    asdf_lite.AsdfFile(dark_tree).write_to(outfile)

    read_tree = {
        "roman": {
            "meta": _ref_meta("READNOISE", sca, pattern_name, ngrp),
            "data": (plane("CDS") / np.sqrt(2.0)).astype(np.float32),
            "resetnoise": plane("RESET"),
            "anc": {
                "ACN": float(h["ACN"]),
                "C_PINK": float(h["C_PINK"]),
                "U_PINK": float(h["U_PINK"]),
                "UNIT": "DN",
            },
            "amp33": amp33,
        },
        "notes": {"noise_header": h.tostring(padding=False)},
    }
    read_path = outfile.replace("_dark_", "_read_")
    asdf_lite.AsdfFile(read_tree).write_to(read_path)
    return outfile, read_path


def main(argv=None):
    """``make_dark <pattern> <first_noise_file_001.fits> <noise_summary>
    <sca> <outfile>`` — the reference's ``make_dark_file.py`` CLI: the
    READS table comes from ``settings_<pattern>.yaml`` (override with
    ``--settings``), and the noise-file list is every consecutive
    ``..._NNN.fits`` sibling of the first one."""
    import argparse
    import os

    import yaml

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("pattern", help="MultiAccum pattern name")
    p.add_argument("target", help="first noise ramp file (ends _001.fits)")
    p.add_argument("noise_summary", help="solid-waffle noise summary FITS")
    p.add_argument("sca", type=int)
    p.add_argument("outfile")
    p.add_argument("--settings", default=None,
                   help="YAML with READS (default settings_<pattern>.yaml)")
    p.add_argument("--nside", type=int, default=None)
    add_device_argument(p)
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    settings = a.settings or f"settings_{a.pattern}.yaml"
    with open(settings) as f:
        reads = [int(r) for r in yaml.safe_load(f)["READS"]]

    if not a.target.endswith("_001.fits"):
        p.error("target must be the first noise file (ending _001.fits)")
    noise_files = []
    nf = 1
    while nf <= 500:
        cand = a.target[:-8] + f"{nf:03d}.fits"
        if not os.path.exists(cand):
            break
        noise_files.append(cand)
        nf += 1
    if not noise_files:
        p.error(f"no noise files found at {a.target}")

    dark_path, read_path = make_dark_and_read_files(
        a.pattern, reads, noise_files, a.noise_summary, a.sca, a.outfile,
        nside=a.nside, device=device,
    )
    print(">>", dark_path)
    print(">>", read_path)
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
