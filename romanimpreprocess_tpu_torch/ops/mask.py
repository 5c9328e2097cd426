"""Boolean masks from DQ bit planes with per-bit growing.

Re-implements the reference's ``CombinedMask`` / ``PixelMask1``
(``utils/maskhandling.py:19-180``).  Bits sharing a grow radius are
OR-combined first and each radius class is dilated once (cross / 3x3 /
5x5).  DQ planes are int32 bit patterns (:func:`..dqflags.i32`).
"""

import numpy as np
import torch

from ..dqflags import flag_bit, i32
from ..io import staging
from .saturation import dilate_box


def _dilate_cross(mask):
    """5-point (cardinal-neighbor) dilation."""
    p = torch.nn.functional.pad(mask, (1, 1, 1, 1))
    return (
        mask
        | p[:-2, 1:-1]
        | p[2:, 1:-1]
        | p[1:-1, :-2]
        | p[1:-1, 2:]
    )


class CombinedMask:
    """Grow-spec mask builder: {flag name or bit: 1|5|9|25}.

    1 = the pixel itself, 5 = cardinal neighbors, 9 = 3x3, 25 = 5x5.
    """

    def __init__(self, maskdict):
        self.growbits = {1: 0, 5: 0, 9: 0, 25: 0}  # grow -> OR'd bitmask
        for key, grow in maskdict.items():
            bit = key if isinstance(key, int) else flag_bit(key)
            self.growbits[int(grow)] |= 1 << bit

    def build(self, dq):
        """dq (ny, nx) — int32 tensor or uint32 numpy — -> boolean
        tensor mask (True = masked), on the tensor's device."""
        if not isinstance(dq, torch.Tensor):
            dq = staging.from_host(np.asarray(dq, np.uint32))
        mask = torch.zeros(dq.shape, dtype=torch.bool, device=dq.device)
        for grow, bits in self.growbits.items():
            if bits == 0:
                continue
            layer = (dq & i32(bits)) != 0
            if grow == 1:
                mask = mask | layer
            elif grow == 5:
                mask = mask | _dilate_cross(layer)
            elif grow == 9:
                mask = mask | dilate_box(layer, 1)
            elif grow == 25:
                mask = mask | dilate_box(layer, 2)
        return mask

    def convert_file(self, file_in, file_mask):
        """L2 ASDF -> mask file: ``.asdf`` (the boolean mask) or
        ``.fits`` (the data with masked pixels at -1000, then an int8
        MASK extension).  Reference ``maskhandling.convert_file:119-149``."""
        from ..io import asdf_lite, fits_lite

        f_in = asdf_lite.open(file_in)
        locmask = self.build(f_in["roman"]["dq"]).numpy()
        if file_mask.endswith(".asdf"):
            asdf_lite.AsdfFile({"mask": locmask}).write_to(file_mask)
        elif file_mask.endswith(".fits"):
            data = np.asarray(f_in["roman"]["data"])
            h1 = fits_lite.PrimaryHDU(
                np.where(locmask, -1000.0, data).astype(np.float32))
            h2 = fits_lite.ImageHDU(np.where(locmask, 1, 0).astype(np.int8),
                                    name="MASK")
            fits_lite.HDUList([h1, h2]).writeto(file_mask, overwrite=True)


#: The canonical mask choice of the reference (``maskhandling.py:154-180``).
PixelMask1 = CombinedMask(
    {
        "DO_NOT_USE": 1,
        "JUMP_DET": 5,
        "DROPOUT": 25,
        "GW_AFFECTED_DATA": 1,
        "PERSISTENCE": 1,
        "AD_FLOOR": 5,
        "UNRELIABLE_ERROR": 1,
        "NON_SCIENCE": 1,
        "DEAD": 9,
        "HOT": 9,
        "WARM": 1,
        "LOW_QE": 9,
        "TELEGRAPH": 1,
        "NO_FLAT_FIELD": 9,
        "NO_GAIN_VALUE": 9,
        "NO_LIN_CORR": 9,
        "NO_SAT_CHECK": 9,
        "UNRELIABLE_BIAS": 1,
        "UNRELIABLE_DARK": 9,
        "UNRELIABLE_SLOPE": 9,
        "UNRELIABLE_FLAT": 9,
        "UNRELIABLE_RESET": 9,
        "OTHER_BAD_PIXEL": 9,
    }
)
