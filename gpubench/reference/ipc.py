"""Spatially-varying 3x3 inter-pixel-capacitance (IPC) operators.

Re-implements the reference's ``ipc_fwd`` / ``ipc_rev`` / ``correct_cube``
(``src/romanimpreprocess/utils/ipc_linearity.py:37-187``).  The forward
operator is

    out[y, x] = sum_{dy,dx in {-1,0,1}} in[y-dy, x-dx] * K[1+dy, 1+dx, y-dy, x-dx]

i.e. each source pixel scatters charge to its neighbors with its *own*
kernel (zero fill outside the array).  The inverse is the same Neumann
series as the reference (``out <- out + in - K*out``, ``order`` times).
"""

import torch.nn.functional as F

_SHIFTS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def shift_zero(arr, dy, dx):
    """shifted[..., y, x] = arr[..., y-dy, x-dx], zero outside."""
    ny, nx = arr.shape[-2:]
    p = F.pad(arr, (1, 1, 1, 1))
    return p[..., 1 - dy : 1 - dy + ny, 1 - dx : 1 - dx + nx]


def ipc_fwd(image, kernel, gain=None):
    """Apply the IPC kernel to an image (..., ny, nx) (electrons, or DN
    if ``gain`` is given, then as g^-1 K g).

    ``kernel`` is (3, 3, ny, nx) with kernel[1+dy, 1+dx, y, x] the
    fraction of pixel (y, x)'s charge appearing at (y+dy, x+dx).
    """
    im = image if gain is None else image * gain
    out = im * kernel[1, 1]
    for dy, dx in _SHIFTS:
        out = out + shift_zero(im * kernel[1 + dy, 1 + dx], dy, dx)
    if gain is not None:
        out = out / gain
    return out


def ipc_rev(image, kernel, order=2, gain=None):
    """Invert the IPC operator by Neumann series to the given order."""
    im = image if gain is None else image * gain
    out = im
    for _ in range(order):
        out = out + im - ipc_fwd(out, kernel)
    if gain is not None:
        out = out / gain
    return out


def correct_cube(data, kernel, gain=None, order=2, nborder=None):
    """IPC-deconvolve every group of a (ngrp, ny, nx) cube.

    The kernel covers only the active region; the border rows and
    columns pass through unchanged.  ``gain`` is the (na, na)
    active-region gain (e/DN) when ``data`` is in DN.  Returns a new
    tensor (the input is not modified).
    """
    ny = data.shape[-2]
    na = kernel.shape[-1]
    nb = (ny - na) // 2 if nborder is None else nborder
    corr = ipc_rev(data[:, nb : ny - nb, nb : ny - nb], kernel,
                   order=order, gain=gain)
    if nb == 0:
        return corr
    out = data.clone()
    out[:, nb : ny - nb, nb : ny - nb] = corr
    return out
