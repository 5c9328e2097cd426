"""L2 output packaging utilities.

Equivalent of the reference's ``L1_to_L2/oututils.py:19-110``: copies
the reference-pixel border and amp33 data (and their dq) from the L1
tree into the L2 structure, stamps the cal_step status dict, and adds
software provenance.
"""

import numpy as np

from .. import __version__
from ..utils import profiling


@profiling.span("host.package.refdata")
def add_in_ref_data(rstruct, l1, pdq, nside, nborder):
    """Copy amp33 + 4-pixel border reference data and flags into the L2
    tree (reference ``oututils.add_in_ref_data:19-55``; the span
    ``host.package.refdata``)."""
    nb = nborder
    data = np.asarray(l1["data"])
    if "amp33" in l1:
        rstruct["amp33"] = np.asarray(l1["amp33"])
    rstruct["border_ref_pix_left"] = data[:, :, :nb].astype(np.float32)
    rstruct["border_ref_pix_right"] = data[:, :, nside - nb:].astype(np.float32)
    rstruct["border_ref_pix_top"] = data[:, nside - nb:, :].astype(np.float32)
    rstruct["border_ref_pix_bottom"] = data[:, :nb, :].astype(np.float32)
    rstruct["dq_border_ref_pix_left"] = np.asarray(pdq[:, :nb], np.uint32)
    rstruct["dq_border_ref_pix_right"] = np.asarray(
        pdq[:, nside - nb:], np.uint32
    )
    rstruct["dq_border_ref_pix_top"] = np.asarray(pdq[nside - nb:, :], np.uint32)
    rstruct["dq_border_ref_pix_bottom"] = np.asarray(pdq[:nb, :], np.uint32)


def cal_step_status(has_dark_decay, wfi18, wfi18_requested, has_wcs=False):
    """The cal_step completion dict (reference ``oututils.update_flags``
    + the per-step markers in ``gen_cal_image:324,570-575``).

    Entries reflect what actually ran: ``assign_wcs`` is COMPLETE only
    when a WCS was supplied and embedded into the L2 meta (otherwise
    N/A — area_factor was unity and the product carries no wcsinfo);
    optional corrections report N/A when their cal input is absent.
    """
    return {
        "dq_init": "COMPLETE",
        "saturation": "COMPLETE",
        "refpix": "COMPLETE",
        "linearity": "COMPLETE",
        "dark": "COMPLETE",
        "ramp_fit": "COMPLETE",
        "flat_field": "COMPLETE",
        "assign_wcs": "COMPLETE" if has_wcs else "N/A",
        "dark_decay": "COMPLETE" if has_dark_decay else "N/A",
        "wfi18_transient": (
            "COMPLETE" if wfi18
            else ("N/A" if wfi18_requested else "SKIPPED")
        ),
    }


def add_in_provenance(meta, ftype="l1_to_l2"):
    """Software provenance stamps (reference
    ``oututils.add_in_provenance:89-110``)."""
    meta["calibration_software_name"] = f"romanimpreprocess_tpu_torch.{ftype}"
    meta["calibration_software_version"] = __version__
