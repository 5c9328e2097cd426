"""Gain and 4D-IPC reference-file production from solid-waffle output.

Equivalent of the reference's ``make_gain_file.py``
(``runs/summer2025run/make_gain_file.py:1-209``): averages the
superpixel gain/IPC-alpha columns of the solid-waffle correlation
summary tables, expands to the full 4096^2 frame, and assembles the
(3, 3, 4088, 4088) IPC kernel with edge zeroing, symmetrization of the
correlation-based couplings, and center normalization to 1.
"""

import numpy as np

from .. import pars
from ..config import resolve_device
from ..io import asdf_lite
from . import add_device_argument

#: solid-waffle summary table column map (reference make_gain_file.py:21)
SW_COLS = {"X": 0, "Y": 1, "N": 2, "g": 5, "aH": 6, "aV": 7, "aD": 10}


def _meta(reftype, sca):
    from . import ref_meta

    return ref_meta(reftype, sca, f"calib.make_gain ({reftype})")


def load_summaries(summary_files):
    """Stack the solid-waffle summary tables: (nfile, nsuper, ncol)."""
    tables = [np.loadtxt(f) for f in summary_files]
    return np.stack(tables)


def superpixel_means(alldata):
    """Per-superpixel means of g/aH/aV/aD over the runs, with the
    array mean filled into superpixels that have no good samples.
    Returns (means dict, good mask, (ny_super, nx_super))."""
    good = np.count_nonzero(alldata[:, :, SW_COLS["N"]], axis=0) > 0
    nx = 1 + int(np.amax(alldata[0, :, SW_COLS["X"]]))
    ny = 1 + int(np.amax(alldata[0, :, SW_COLS["Y"]]))
    means = {}
    import warnings

    for e in ("g", "aH", "aV", "aD"):
        vals = np.where(
            alldata[:, :, SW_COLS["N"]] > 0, alldata[:, :, SW_COLS[e]], np.nan
        )
        with warnings.catch_warnings():
            # all-bad superpixels produce empty-slice means; they are
            # filled with the array mean below
            warnings.simplefilter("ignore", RuntimeWarning)
            m = np.nanmean(vals, axis=0)
        m = np.where(good, m, np.nanmean(m[good]))
        means[e] = m
    return means, good, (ny, nx)


def expand_superpixels(values, grid, nside, nborder=4):
    """Repeat a superpixel grid to the full frame; border zeroed."""
    ny, nx = grid
    full = np.repeat(
        np.repeat(values.reshape(grid), nside // ny, axis=0),
        nside // nx, axis=1,
    )
    nb = nborder
    full[:nb, :] = 0.0
    full[-nb:, :] = 0.0
    full[:, :nb] = 0.0
    full[:, -nb:] = 0.0
    return full


def assemble_ipc_kernel(alpha_h, alpha_v, alpha_d):
    """(3, 3, na, na) IPC kernel from active-region alpha maps.

    Edge couplings that would leave the science array are zeroed, the
    four independent couplings are symmetrized between pixel pairs, and
    the center is set to 1 - sum(neighbors).
    """
    na = alpha_h.shape[0]
    K = np.zeros((3, 3, na, na), dtype=np.float64)
    K[1, 0] = K[1, 2] = alpha_h
    K[0, 1] = K[2, 1] = alpha_v
    K[0, 0] = K[2, 2] = K[0, 2] = K[2, 0] = alpha_d

    # zero couplings that exit the array
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy < 0:
                K[1 + dy, 1 + dx, :(-dy), :] = 0.0
            if dy > 0:
                K[1 + dy, 1 + dx, -dy:, :] = 0.0
            if dx < 0:
                K[1 + dy, 1 + dx, :, :(-dx)] = 0.0
            if dx > 0:
                K[1 + dy, 1 + dx, :, -dx:] = 0.0

    # symmetrize: coupling (y,x)->(y+dy,x+dx) equals (y+dy,x+dx)->(y,x)
    for dy, dx in ((1, 0), (0, 1), (1, 1), (1, -1)):
        ymin = max(0, -dy)
        ymax = na + ymin - abs(dy)
        xmin = max(0, -dx)
        xmax = na + xmin - abs(dx)
        fwd = K[1 + dy, 1 + dx, ymin:ymax, xmin:xmax]
        rev = K[1 - dy, 1 - dx, ymin + dy : ymax + dy, xmin + dx : xmax + dx]
        sym = 0.5 * (fwd + rev)
        K[1 + dy, 1 + dx, ymin:ymax, xmin:xmax] = sym
        K[1 - dy, 1 - dx, ymin + dy : ymax + dy, xmin + dx : xmax + dx] = sym

    K[1, 1] = 0.0
    K[1, 1] = 1.0 - K.sum(axis=(0, 1))
    return K.astype(np.float32)


def make_gain_and_ipc_files(summary_files, sca, outfile, nside=None,
                            config_notes=""):
    """Build the gain + ipc4d ASDF files.  Returns (gain_path, ipc_path)."""
    nside = nside or pars.nside
    nb = pars.nborder
    alldata = load_summaries(summary_files)
    means, good, grid = superpixel_means(alldata)

    good_full = expand_superpixels(good.astype(np.float64), grid, nside) > 0.5
    gain_full = expand_superpixels(means["g"], grid, nside).astype(np.float32)

    asdf_lite.AsdfFile(
        {
            "roman": {
                "meta": _meta("GAIN", sca),
                "data": gain_full,
                "dq": np.where(good_full, 0, 2**19).astype(np.uint32),
            },
            "notes": {"solid_waffle_config": config_notes},
        }
    ).write_to(outfile)

    act = slice(nb, nside - nb)
    K = assemble_ipc_kernel(
        expand_superpixels(means["aH"], grid, nside)[act, act],
        expand_superpixels(means["aV"], grid, nside)[act, act],
        expand_superpixels(means["aD"], grid, nside)[act, act],
    )
    ipc_path = outfile.replace("_gain_", "_ipc4d_")
    asdf_lite.AsdfFile(
        {
            "roman": {
                "meta": _meta("IPC4D", sca),
                # dq matches the ACTIVE-region kernel's spatial shape
                # (reference trims Kernel_good[4:-4, 4:-4],
                # make_gain_file.py:160-175) — a full-frame dq would be
                # read 4 px misaligned by active-coordinate consumers
                "data": K,
                "dq": np.where(good_full[act, act], 0, 1).astype(np.uint32),
            },
            "notes": {"solid_waffle_config": config_notes},
        }
    ).write_to(ipc_path)
    return outfile, ipc_path


def main(argv=None):
    """``make_gain <summaries> <sca> <outfile>`` — the reference's
    ``make_gain_file.py`` CLI: ``summaries`` is a text file listing one
    solid-waffle summary file per line."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("summaries",
                   help="text file: one solid-waffle summary path per line")
    p.add_argument("sca", type=int)
    p.add_argument("outfile", help="gain output path (contains '_gain_')")
    p.add_argument("--nside", type=int, default=None)
    add_device_argument(p)
    a = p.parse_args(argv)
    resolve_device(a.device)  # host code: checked as in every calib CLI

    with open(a.summaries) as f:
        sfiles = [ln.strip() for ln in f if ln.strip()]
    notes = f"summaries from {a.summaries}: " + ", ".join(sfiles)
    gain_path, ipc_path = make_gain_and_ipc_files(
        sfiles, a.sca, a.outfile, nside=a.nside, config_notes=notes
    )
    print(">>", gain_path)
    print(">>", ipc_path)
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
