"""Boolean masks from DQ bit planes with per-bit growing.

Re-implements the reference's ``CombinedMask`` / ``PixelMask1``
(``utils/maskhandling.py:19-180``).  Bits sharing a grow radius are
OR-combined first and each radius class is dilated once (cross / 3x3 /
5x5).  DQ planes are int32 bit patterns (:func:`..dqflags.i32`).
"""

import numpy as np
import torch

from .dqflags import flag_bit, i32
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


def as_dq_tensor(dq, device=None):
    """A uint32 numpy DQ plane (or an int32 tensor) as an int32 tensor."""
    if isinstance(dq, torch.Tensor):
        return dq.to(device) if device is not None else dq
    arr = np.ascontiguousarray(np.asarray(dq, np.uint32)).view(np.int32)
    return torch.from_numpy(arr).to(device or "cpu")


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
        dq = as_dq_tensor(dq)
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
