"""Saturation flagging for resultant cubes.

Replicates the semantics the reference gets from
``romancal.saturation.flag_saturation`` (called via
``gen_cal_image.saturation_check:148-185`` with ``n_pix_grow_sat=1``):

1. a resultant is SATURATED where its value >= the saturation threshold
   (pixels whose saturation-reference dq carries NO_SAT_CHECK are never
   flagged, and get NO_SAT_CHECK in the pixel dq),
2. a resultant at or below the A/D floor (<= 0) gets AD_FLOOR|DO_NOT_USE,
3. saturation propagates forward in time,
4. ``backup`` resultants *before* the first saturated one are
   retro-flagged,
5. the per-resultant saturated set grows spatially by ``n_pix_grow_sat``
   pixels (a (2n+1)^2 box dilation with SAME padding).

DQ tensors are int32 bit patterns (:func:`..dqflags.i32`).
"""

import torch
import torch.nn.functional as F

from .dqflags import group as gdq
from .dqflags import i32, pixel


def dilate_box(mask, n):
    """(2n+1)^2 box dilation of a boolean (..., ny, nx) mask (SAME
    padding: nothing grows in from outside the array)."""
    if n <= 0:
        return mask
    shape = mask.shape
    x = mask.reshape((-1,) + shape[-2:]).to(torch.float32)
    x = F.max_pool2d(x, kernel_size=2 * n + 1, stride=1, padding=n)
    return x.reshape(shape) > 0


def flag_saturation(data, rdq, pdq, sat_thresh, sat_dq,
                    backup=1, skip_first=1, n_pix_grow_sat=1):
    """Flag saturated / A-D-floor resultants.

    data (ngrp, ny, nx) resultants; rdq (ngrp, ny, nx) and pdq (ny, nx)
    int32 dq; sat_thresh (ny, nx) float32 threshold (DN); sat_dq
    (ny, nx) int32 dq of the saturation reference file.  Returns new
    (rdq, pdq).
    """
    ngrp = data.shape[0]
    no_check = (sat_dq & i32(pixel.NO_SAT_CHECK)) != 0
    checkable = (torch.arange(ngrp, device=data.device) >= skip_first)[:, None, None]

    sat = (data >= sat_thresh[None]) & ~no_check[None] & checkable
    floor = (data <= 0) & checkable

    # forward propagation: cumulative any over groups
    sat = torch.cumsum(sat.to(torch.int32), dim=0) > 0
    # retro-flag `backup` earlier resultants from the PRE-LOOP mask
    # (shifting the running result would compound the shifts)
    sat0 = sat
    for b in range(1, backup + 1):
        shifted = torch.zeros_like(sat0)
        shifted[: ngrp - b] = sat0[b:]
        sat = sat | shifted
    sat = dilate_box(sat, n_pix_grow_sat)
    # the grow/backup must not flag the skipped leading resultants
    sat = sat & checkable

    zero = torch.zeros((), dtype=torch.int32, device=data.device)
    rdq_out = (
        rdq
        | torch.where(sat, i32(gdq.SATURATED), zero)
        | torch.where(floor, i32(gdq.AD_FLOOR | gdq.DO_NOT_USE), zero)
    )
    pdq_out = pdq | torch.where(no_check, i32(pixel.NO_SAT_CHECK), zero)
    return rdq_out, pdq_out
