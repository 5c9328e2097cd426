"""Hand-written CUDA kernel for the cube linearity correction.

Replaces the TPU kernel ``ops/linearity_pallas.py``
``apply_linearity_cube_fused`` of the JAX package.  The kernel
(``csrc/linearity.cu``) runs one thread per pixel over all groups, so
the coefficient stack and the smin/smax/sref/dq planes are read once;
its plain twin is :func:`.linearity.apply_linearity_cube`, with which
it agrees bit for bit (cube and DQ).

Bound: bytes.  At 4096^2 x 6 groups with 4 coefficients it must move
about 1.51 GB (:func:`bytes_moved`).
"""

import torch

from . import cuda_build
from .linearity import apply_linearity_cube

#: launches of the CUDA kernel since the last reset (set it to 0 to reset)
launches = 0

MAX_COEFS = 8


def bytes_moved(ngrp, ny, nx, ncoef):
    """Least bytes the function must move: S, coefs, smin/smax/sref/dq
    and attempt (1 byte) read once; the cube and dq written once."""
    npix = ny * nx
    return npix * (4 * ngrp + 4 * ncoef + 16 + ngrp + 4 * ngrp + 4)


def apply_linearity_cube_fused(S, lin, attempt, do_not_flag_first=True):
    """Drop-in for :func:`.linearity.apply_linearity_cube`.

    ``lin`` is a :class:`.linearity.LinearityData` (dq int32);
    ``attempt`` is the (ngrp, ny, nx) boolean attempt-correction gate.
    Returns (Slin cube float32, accumulated dq plane int32).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if S.device.type == "cpu":
        return apply_linearity_cube(S, lin, do_not_flag_first, attempt)
    global launches
    ngrp, ny, nx = S.shape
    nc = lin.coefs.shape[0]
    if not 1 <= nc <= MAX_COEFS:
        raise ValueError(f"linearity kernel takes 1..{MAX_COEFS} "
                         f"coefficients, got {nc}")
    req = cuda_build.require
    req(S, "S", torch.float32, (ngrp, ny, nx))
    req(lin.coefs, "coefs", torch.float32, (nc, ny, nx))
    for name in ("smin", "smax", "sref"):
        req(getattr(lin, name), name, torch.float32, (ny, nx))
    req(lin.dq, "dq", torch.int32, (ny, nx))
    req(attempt, "attempt", torch.bool, (ngrp, ny, nx))
    phi = torch.empty_like(S)
    dqo = torch.empty_like(lin.dq)
    lib = cuda_build.library("linearity.cu")
    with torch.cuda.device(S.device):
        err = lib.linearity_cube_launch(
            S.data_ptr(), lin.coefs.data_ptr(), lin.smin.data_ptr(),
            lin.smax.data_ptr(), lin.sref.data_ptr(), lin.dq.data_ptr(),
            attempt.data_ptr(), phi.data_ptr(), dqo.data_ptr(),
            ngrp, nc, ny * nx, int(bool(do_not_flag_first)),
            cuda_build.stream_ptr(S),
        )
    cuda_build.check(err, "linearity_cube_launch")
    launches += 1
    return phi, dqo
