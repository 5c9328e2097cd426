"""Calibration-reference-file production (the reference's ``runs/`` layer).

Writers of the CALDIR reference files from raw detector test data:

- :mod:`.convert`     — merge per-frame FITS exposures into ramp cubes
  with detector->science flips and slope extensions
  (``runs/summer2025run/convert_dark.py`` etc.)
- :mod:`.make_dark`   — sigma-clipped group-averaged dark cube + dark
  slope + read/reset-noise files (``make_dark_file.py``)
- :mod:`.make_gain`   — gain map + 4D IPC kernel from solid-waffle
  correlation summaries (``make_gain_file.py``)
- :mod:`.characterize` — per-pixel Legendre linearity fit, photon-transfer
  gain, IPC alphas from autocorrelations
- :mod:`.postprocess` — p-flat, saturation, and bias-correction files
  from the linearity solution (``postprocess_calfiles.py``)
- :mod:`.makemask`    — pixel mask from flat/dark thresholds
  (``makemask.py`` incl. the 2026_July gain-dq variant)
- :mod:`.swconfig`    — solid-waffle / linearity-fit configuration
  emitters (the reference's Perl generators, in Python)
- :mod:`.mast`        — MAST / TVAC uncal ASDF -> ramp-cube FITS

The sigma-clipped stacking, the linearity fit, the photon-transfer gain,
the p-flat's sky fit and the per-read inverse-linearity forward model of
the bias correction run on a torch device: their entry points take
``device=`` (default ``cuda``, raising without a GPU).  The other
writers are host code.  Every CLI takes ``--device`` and resolves it
the same way, so a CLI never carries on on the CPU unasked.
"""

from datetime import datetime, timezone

from .. import __version__


def ref_meta(reftype, sca, description, exposure=None,
             author="romanimpreprocess_tpu_torch.calib"):
    """Shared reference-file ``meta`` block (SOC-style provenance, cf.
    reference ``make_dark_file.py:106-138``)."""
    meta = {
        "author": author,
        "description": description,
        "instrument": {"detector": f"WFI{sca:02d}", "name": "WFI"},
        "origin": "PIT - romanimpreprocess_tpu_torch",
        "date": datetime.now(timezone.utc).isoformat(),
        "pedigree": "DUMMY",
        "reftype": reftype,
        "telescope": "ROMAN",
        "useafter": "2020-01-01T00:00:00.000",
        "software_version": __version__,
    }
    if exposure is not None:
        meta["exposure"] = exposure
    return meta


def add_device_argument(parser):
    """``--device`` for a calib CLI (default ``cuda``; the CLI resolves
    it with :func:`..config.resolve_device`)."""
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without a GPU)")
