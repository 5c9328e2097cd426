"""Linearity correction of a resultant cube (plain PyTorch).

Re-implements the reference's ``linearity`` / ``multilin``
(``src/romanimpreprocess/utils/ipc_linearity.py:234-344``).  The
calibration model: raw signal S (DN_raw) maps to linearized signal
(DN_lin) through a per-pixel Legendre expansion on

    z = -1 + 2 (S - Smin) / (Smax - Smin).

:func:`apply_linearity` linearizes one frame; :func:`apply_linearity_cube`
a resultant cube, and is also the plain twin of the CUDA kernel
in :mod:`.linearity_cuda`.  DQ planes are int32 bit patterns
(:func:`..dqflags.i32`).
"""

from typing import NamedTuple

import torch

from .dqflags import i32, pixel
from .legendre import legendre_eval

NO_LIN_CORR = i32(pixel.NO_LIN_CORR)
FALLBACK_BITS = i32(pixel.NO_LIN_CORR | pixel.REFERENCE_PIXEL)


class LinearityData(NamedTuple):
    """Linearity calibration tensors (full frame)."""

    coefs: torch.Tensor  # (order+1, ny, nx) Legendre coefficients
    smin: torch.Tensor  # (ny, nx) DN at z=-1
    smax: torch.Tensor  # (ny, nx) DN at z=+1
    sref: torch.Tensor  # (ny, nx) DN corresponding to 0 e in well
    dq: torch.Tensor  # (ny, nx) int32 bit pattern of the uint32 dq


def rescale(S, lin):
    """S (DN_raw) -> z in the Legendre domain."""
    return -1.0 + 2.0 * (S - lin.smin) / (lin.smax - lin.smin)


def apply_linearity(S, lin):
    """Linearize a single 2-D frame.  Returns (Slin, dq).

    Mirrors reference ``linearity`` (``ipc_linearity.py:234-273``):
    evaluates the expansion with linear extrapolation and ORs
    NO_LIN_CORR into the calibration dq where extrapolating.
    """
    phi, exflag = legendre_eval(rescale(S, lin), lin.coefs)
    zero = torch.zeros((), dtype=torch.int32, device=S.device)
    return phi, lin.dq | torch.where(exflag, NO_LIN_CORR, zero)


def apply_linearity_cube(S, lin, do_not_flag_first=True, attempt_corr=None):
    """Linearize a (ngrp, ny, nx) cube.  Returns (Slin cube, dq 2-D).

    Semantics follow reference ``multilin``:

    - group 0's z is clipped to [-1, 1] when ``do_not_flag_first``,
    - extrapolation (|z| > 1) flags NO_LIN_CORR, gated by
      ``attempt_corr`` and skipping group 0 when ``do_not_flag_first``,
    - group g falls back to ``S - Sref`` where the dq it sees — the
      calibration dq, OR NO_LIN_CORR if an EARLIER group raised a flag
      (the reference accumulates flags into one array across its group
      loop) — holds NO_LIN_CORR or REFERENCE_PIXEL.
    """
    if attempt_corr is None:
        attempt_corr = torch.ones(S.shape, dtype=torch.bool, device=S.device)
    z = rescale(S, lin)
    if do_not_flag_first:
        z = torch.cat([torch.clamp(z[:1], -1.0, 1.0), z[1:]])
    phi, exflag = legendre_eval(z, lin.coefs[:, None])
    newflag = exflag & attempt_corr
    if do_not_flag_first:
        newflag[0] = False
    # exclusive prefix OR over groups: has an earlier group flagged?
    seen = torch.cumsum(newflag.to(torch.int32), dim=0) - newflag.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=S.device)
    dq_g = lin.dq[None] | torch.where(seen > 0, NO_LIN_CORR, zero)
    phi = torch.where((dq_g & FALLBACK_BITS) == 0, phi, S - lin.sref)
    dq = lin.dq | torch.where(newflag.any(dim=0), NO_LIN_CORR, zero)
    return phi.to(torch.float32), dq
