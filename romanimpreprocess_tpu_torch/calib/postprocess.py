"""P-flat, saturation, and bias-correction production.

Equivalent of the reference's ``postprocess_calfiles.py``
(``runs/summer2025run/postprocess_calfiles.py:1-172``):

- **pflat**: the linearity file's pflat plane normalized by its own
  order-2 medfit (removing the L-flat-scale structure) and rescaled by
  ``g_ideal / median(gain)``; outliers clipped to [0.01, 1.99] and
  flagged,
- **saturation**: ``Smax - 1`` with dq where the linearity solution is
  inverted (Smax <= Sref),
- **biascorr**: the observed group-averaged dark minus the dark
  forward-modeled through the inverse linearity per raw read — the
  per-read inverse-linearity evaluations (the reference's slowest
  production loop) run on a torch device.
"""

import numpy as np
import torch

from .. import pars
from ..config import reads_to_pattern, resolve_device
from ..io import asdf_lite, staging
from ..ops import linearity, sky
from . import add_device_argument


def _meta(reftype, sca):
    from . import ref_meta

    return ref_meta(reftype, sca, f"calib.postprocess ({reftype})")


def make_pflat_file(lin_file, gain_file, out_path, sca, medfit_N=6, device=None):
    """pflat = pflat / medfit(pflat) * g_ideal / median(gain).

    The sky fit runs in float32 on ``device`` (default ``cuda``) with
    the plain block medians, as the reference's runs without float64;
    the division is float64 on the host."""
    lin = asdf_lite.open(lin_file)["roman"]
    gain = asdf_lite.open(gain_file)["roman"]["data"]
    pflat = np.asarray(lin["pflat"])
    if pflat.ndim == 3:
        pflat = pflat[0]
    pflat = pflat.astype(np.float64)

    dev = resolve_device(device)
    _, pfmed = sky.medfit(torch.from_numpy(pflat.astype(np.float32)).to(dev),
                          N=medfit_N, order=2)
    pflat = pflat / pfmed.cpu().numpy()
    pflat = pflat * pars.g_ideal / np.median(gain)

    dq = np.zeros(pflat.shape, dtype=np.uint32)
    dq |= np.where((pflat < 0.01) | (pflat > 1.99), 1, 0).astype(np.uint32)
    pflat = np.clip(pflat, 0.01, 1.99)

    asdf_lite.AsdfFile(
        {
            "roman": {
                "meta": _meta("PFLAT", sca),
                "data": pflat.astype(np.float32),
                "dq": dq,
            },
            "notes": {"src": lin_file},
        }
    ).write_to(out_path)
    return out_path


def make_saturation_file(lin_file, out_path, sca):
    """saturation = Smax - 1, flagged where Smax <= Sref."""
    lin = asdf_lite.open(lin_file)["roman"]
    smax = np.clip(np.asarray(lin["Smax"]), 1, 65535).astype(np.float32)
    dq = np.where(
        np.asarray(lin["Smax"]) > np.asarray(lin["Sref"]), 0, 1
    ).astype(np.uint32)
    asdf_lite.AsdfFile(
        {
            "roman": {
                "meta": _meta("SATURATION", sca),
                "data": smax - 1,
                "dq": dq,
            },
            "notes": {"src": lin_file},
        }
    ).write_to(out_path)
    return out_path


def _predicted_dark_run(dark_dn_frame, lin_pack, g_of_r, wgt, xref, ngrp):
    """Sum each read's inverse-linearity forward model into its group
    (``g_of_r[r] == ngrp``: a read outside every group, skipped)."""
    acc = torch.zeros((ngrp,) + tuple(dark_dn_frame.shape), dtype=torch.float32,
                      device=dark_dn_frame.device)
    for r, (g, w) in enumerate(zip(g_of_r, wgt)):
        if g == ngrp:
            continue
        slin = dark_dn_frame * float(np.float32(r) - xref)
        s_raw, _ = linearity.invert_linearity(slin, lin_pack)
        acc[g] += s_raw * float(w)
    return acc


def predicted_dark_cube(dark_slope_act, lin_pack, read_pattern, frame_time,
                        xref, device=None):
    """Forward-model the dark through the inverse linearity per read and
    average within groups, on ``device`` (default ``cuda``; ``lin_pack``,
    an :class:`..ops.linearity.LinearityData`, is moved there).  Returns
    (ngrp, na, na) float32 (host).

    ``xref`` is the (fractional) frame index at which the linearized
    signal is zero (the bias reference frame).  Reads are summed into
    their groups in read order, in float32.
    """
    dev = resolve_device(device)
    ngrp = len(read_pattern)
    lastread = read_pattern[-1][-1]
    g_of_r = np.full(lastread + 1, ngrp, np.int32)
    wgt = np.zeros(lastread + 1, np.float32)
    for j, grp in enumerate(read_pattern):
        for r in grp:
            g_of_r[r] = j
            wgt[r] = 1.0 / len(grp)

    pack = linearity.LinearityData(*(a.to(dev) for a in lin_pack))
    dark_dn = torch.from_numpy(np.asarray(dark_slope_act * frame_time, np.float32)).to(dev)
    return _predicted_dark_run(dark_dn, pack, g_of_r.tolist(), wgt, np.float32(xref),
                               ngrp).cpu().numpy()


def make_biascorr_file(lin_file, dark_file, out_path, sca, reads,
                       frame_time=3.04, bias_frame=1, device=None):
    """biascorr = observed group-averaged dark - forward-modeled dark.

    ``bias_frame`` indexes the READS pair whose center defines the zero
    of the linearized signal (the reference's linearity-fit BIAS SLICE).
    The forward model runs on ``device`` (default ``cuda``).
    """
    nb = pars.nborder
    read_pattern = reads_to_pattern(reads)
    dark = asdf_lite.open(dark_file)["roman"]
    lin_tree = asdf_lite.open(lin_file)["roman"]
    nside = np.asarray(lin_tree["Smin"]).shape[0]
    act = slice(nb, nside - nb)

    def plane(key, dtype=np.float32):  # on the host, in the staged dtypes
        return staging.from_host(np.asarray(lin_tree[key], dtype)[..., act, act])

    lin_pack = linearity.LinearityData(
        plane("data"), plane("Smin"), plane("Smax"), plane("Sref"), plane("dq", np.uint32))

    xref = (reads[2 * bias_frame] + reads[2 * bias_frame + 1] - 1) / 2.0
    dark_slope_act = np.asarray(dark["dark_slope"])[act, act]
    predicted = predicted_dark_cube(
        dark_slope_act, lin_pack, read_pattern, frame_time, xref, device=device
    )
    observed = np.asarray(dark["data"])[:, act, act].astype(np.float32)
    bias_corr = observed - predicted

    asdf_lite.AsdfFile(
        {
            "roman": {
                "meta": _meta("BIASCORR", sca),
                "data": bias_corr.astype(np.float32),
                "t0": float(frame_time * xref),
                "t0_comment": (
                    "seconds after reset defining Sref (0 DN_lin)"
                ),
            }
        }
    ).write_to(out_path)
    return out_path


def main(argv=None):
    """``postprocess <linearitylegendre_file> <sca> <pattern>`` — the
    reference's ``postprocess_calfiles.py`` CLI: derives the gain input
    and the pflat/saturation/biascorr outputs by the
    ``_linearitylegendre_`` name substitution, with READS from
    ``settings_<pattern>.yaml`` (override with ``--settings``)."""
    import argparse

    import yaml

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("infile", help="linearitylegendre ASDF (name contains "
                                  "'_linearitylegendre_')")
    p.add_argument("sca", type=int)
    p.add_argument("pattern", help="MultiAccum pattern name")
    p.add_argument("--settings", default=None)
    p.add_argument("--frame-time", type=float, default=3.04)
    p.add_argument("--bias-frame", type=int, default=1)
    add_device_argument(p)
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    if "_linearitylegendre_" not in a.infile:
        p.error("input name must contain '_linearitylegendre_'")
    settings = a.settings or f"settings_{a.pattern}.yaml"
    with open(settings) as f:
        reads = [int(r) for r in yaml.safe_load(f)["READS"]]

    sub = a.infile.replace
    print(">>", make_pflat_file(
        a.infile, sub("_linearitylegendre_", "_gain_"),
        sub("_linearitylegendre_", "_pflat_"), a.sca, device=device))
    print(">>", make_saturation_file(
        a.infile, sub("_linearitylegendre_", "_saturation_"), a.sca))
    print(">>", make_biascorr_file(
        a.infile, sub("_linearitylegendre_", "_dark_"),
        sub("_linearitylegendre_", "_biascorr_"), a.sca, reads,
        frame_time=a.frame_time, bias_frame=a.bias_frame, device=device))
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
