"""Flat-field handling (standalone API).

Equivalent of the reference's ``utils/flatutils.get_flat``
(``flatutils.py:20-76``): border padded with 1, out-of-range pixels
flagged NO_FLAT_FIELD and clipped to [0.1, 10], then IPC-deconvolved in
DN space (gain conjugation) with NO_GAIN_VALUE flagging.

The L1->L2 device core fuses this logic inline
(``pipeline/l1_to_l2.make_core``); this module is the standalone entry
for calibration QA and external consumers.  DQ is an int32 bit pattern
(:func:`..dqflags.i32`).
"""

import torch

from ..dqflags import i32, pixel
from . import ipc


def get_flat(flat, gain=None, ipc_kernel=None, nborder=4, pdq=None,
             ipc_deconvolve=True):
    """Flat field in DN units with optional IPC deconvolution.

    Parameters
    ----------
    flat : (ny, nx) p-flat (full frame), float32 tensor.
    gain : (ny, nx) e/DN (full frame), required when deconvolving.
    ipc_kernel : (3, 3, na, na) active-region kernel or None.
    pdq : optional (ny, nx) int32 DQ to OR quality flags into.

    Returns (flat_dn, pdq) -- pdq is None if not supplied.
    """
    ny = flat.shape[0]
    nb = nborder
    act = (slice(nb, ny - nb), slice(nb, ny - nb))
    dev = flat.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    out = torch.ones((ny, ny), dtype=torch.float32, device=dev)
    out[act] = flat[act]

    if pdq is not None:
        pdq = pdq | torch.where((out < 0.1) | (out > 10.0),
                                i32(pixel.NO_FLAT_FIELD), zero)
    out = torch.clamp(out, 0.1, 10.0)

    if ipc_deconvolve and ipc_kernel is not None:
        g = gain[act]
        if pdq is not None:
            pdq = pdq.clone()
            pdq[act] |= torch.where(g <= 0.1, i32(pixel.NO_GAIN_VALUE), zero)
        g = torch.clamp(g, min=0.1)
        out[act] = ipc.ipc_rev(out[act], ipc_kernel, gain=g)
    return out, pdq
