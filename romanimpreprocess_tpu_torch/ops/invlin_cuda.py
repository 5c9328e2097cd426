"""Hand-written CUDA kernel for the bisection inverse of the linearity.

Kernel D (``csrc/invlin.cu``): the sim's IL forward model ends with
``linearity.invert_linearity(x / gain, lin)``, 24 bisection steps of a
Legendre expansion.  The JAX package has no TPU kernel for it (XLA
fuses the unrolled loop); in PyTorch each step is about 40 elementwise
launches over the whole cube.  The kernel runs one thread per active
pixel over all groups, fusing the division by the gain, and agrees with
the plain path bit for bit (``S`` and ``exflag``).

Bound: operations, about 110 G unfused float32 operations at
8 x 4088^2 with 7 coefficients (:func:`flops`), 3.3 ms at 33.5 T a
second, against 1.87 GB (:func:`bytes_moved`, 0.56 ms).
"""

import torch

from . import cuda_build
from .linearity import LinearityData, invert_linearity

#: launches of the CUDA kernel since the last reset (set it to 0 to reset)
launches = 0

MAX_COEFS = 8
MAX_ITER = 64


def _ops_per_step(ncoef):
    """float32 operations of one bisection step: the expansion (a
    product and a sum per term past the first), the recursion (four per
    polynomial read), the comparison and the step."""
    return 2 * (ncoef - 1) + 4 * max(ncoef - 2, 0) + 2


def flops(ngrp, na, ncoef, niter=24):
    """float32 operations of one call on (ngrp, na, na): per pixel and
    group the division, ``niter`` steps, the final map (three) and the
    last |z| > 1 test (two); per pixel the half span (two)."""
    npix = na * na
    return npix * (ngrp * (1 + niter * _ops_per_step(ncoef) + 5) + 2)


def bytes_moved(ngrp, na, ncoef):
    """Least bytes a call must move: x, the gain, the coefficients,
    smin and smax of the active region read once; S (float32) and
    exflag (1 byte) written once."""
    npix = na * na
    return npix * (4 * ngrp + 4 + 4 * ncoef + 8 + 4 * ngrp + ngrp)


def invert_linearity_plain(x, gain, lin, niter=24):
    """Plain PyTorch version of the kernel:
    ``linearity.invert_linearity(x / gain[act, act], lin[act, act])``
    on the centred window ``act`` of the full frames that ``x``'s
    trailing axes cover."""
    nb = (gain.shape[-1] - x.shape[-1]) // 2
    act = slice(nb, gain.shape[0] - nb) if nb else slice(None)
    lin_act = LinearityData(lin.coefs[:, act, act], lin.smin[act, act],
                            lin.smax[act, act], lin.sref[act, act], lin.dq[act, act])
    return invert_linearity(x / gain[act, act], lin_act, niter)


def invert_linearity_fused(x, gain, lin, niter=24):
    """:func:`invert_linearity_plain` as one kernel launch.

    ``x`` is a (ngrp, na, na) batch or one (na, na) frame of linearized
    DN (electrons through the IPC, before the division by the gain);
    ``gain`` (ny, nx) and ``lin`` (:class:`.linearity.LinearityData`,
    (order+1, ny, nx) coefficients) are full frames whose centred
    na x na window is the active region.  Returns (S float32, exflag
    bool), shaped as ``x``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel.
    """
    if x.device.type == "cpu":
        return invert_linearity_plain(x, gain, lin, niter)
    global launches
    flat = x.ndim == 2
    xb = x[None] if flat else x
    ngrp, na, _ = xb.shape
    ny, nx = gain.shape
    nb = (nx - na) // 2
    nc = lin.coefs.shape[0]
    if not 1 <= nc <= MAX_COEFS:
        raise ValueError(f"inverse linearity kernel takes 1..{MAX_COEFS} "
                         f"coefficients, got {nc}")
    if not 1 <= niter <= MAX_ITER:
        raise ValueError(f"inverse linearity kernel takes 1..{MAX_ITER} steps, "
                         f"got {niter}")
    if ny != nx or na > nx or (nx - na) % 2:
        raise ValueError(f"x's {na}x{na} frame is not centred in the {ny}x{nx} "
                         "calibration frame")
    req = cuda_build.require
    req(xb, "x", torch.float32, (ngrp, na, na))
    req(gain, "gain", torch.float32, (ny, nx))
    req(lin.coefs, "coefs", torch.float32, (nc, ny, nx))
    req(lin.smin, "smin", torch.float32, (ny, nx))
    req(lin.smax, "smax", torch.float32, (ny, nx))
    S = torch.empty_like(xb)
    ex = torch.empty(xb.shape, dtype=torch.bool, device=xb.device)
    lib = cuda_build.library("invlin.cu")
    with torch.cuda.device(xb.device):
        err = lib.invert_linearity_launch(
            xb.data_ptr(), gain.data_ptr(), lin.coefs.data_ptr(),
            lin.smin.data_ptr(), lin.smax.data_ptr(), S.data_ptr(), ex.data_ptr(),
            ngrp, nc, na, nx, ny * nx, nb, niter, cuda_build.stream_ptr(xb),
        )
    cuda_build.check(err, "invert_linearity_launch")
    launches += 1
    return (S[0], ex[0]) if flat else (S, ex)
