"""Hand-written CUDA kernels for the IPC operators: the order-2 inverse
on the frame and one forward application on a cube.

Replaces the TPU kernel ``ops/ipc_pallas.py`` ``ipc_rev2_frame_stream``
of the JAX package.  :func:`ipc_rev2_frame` reads the raw (ngrp, nside,
nside) cube, the nine border-zeroed kernel planes of
:func:`kernel_planes_frame` and the gain once, and writes

    out = (3 y - 3 K y + K K y) / gain,   y = data * gain

(as the Neumann recursion ``o <- (o + y) - K o`` from ``o = y``) on
the active region and the input unchanged on the border.  Its plain
twin is :func:`ipc_rev2_frame_plain` (the CPU path and ``IPC_BACKEND:
xla``), with which it agrees bit for bit.  On the card it is one launch
of the slab module's row-streaming kernel (``csrc/ipc_slab.cu``,
:mod:`.ipc_slab`) compiled for the Neumann order: the twin's rounded
steps in its order, on the frame's active view in place, the sources
of the border read from the frame, the border copied by the same
launch.

Bound: bytes, about 1.48 GB at 4096^2 x 6 groups (:func:`bytes_moved`).

:func:`ipc_rev2_frame` is :func:`ipc_rev2_rows` on the whole frame:
the same inverse on a row slab of the frame (the row-sharded
calibration of :mod:`..parallel.spatial`), the slab's rows with a halo
of other slabs' rows above and below, the output its own rows only.
The launch takes the slab's row count: the halo rows are read as
sources with their real weights, the frame's border rows only where the
slab holds the frame's top or bottom edge.  Its plain twin
:func:`ipc_rev2_rows_plain` is :func:`.ipc.ipc_rev` on the whole slab,
trimmed to its own rows; both agree bit for bit with the frame inverse
on those rows (``ipc_slab.NEUMANN_EXT`` rows of halo suffice).

:func:`ipc_fwd_cube` replaces the TPU kernel ``ops/ipc_pallas.py``
``ipc_fwd_cube_blocked``: one forward application of K to every group
of an active-region cube, the sim's IL forward model.  The kernel
(``csrc/ipc_fwd.cu``) takes the raw (3, 3, na, na) kernel as nine planes
(the TPU kernel's padded slab layout has no counterpart here) and
zero-fills the edge with a bounds check.  Its plain twin is
:func:`.ipc.ipc_fwd`, with which it agrees bit for bit.  Bound: bytes,
about 1.40 GB at 6 groups of 4088^2 (:func:`fwd_bytes_moved`).
"""

import numpy as np
import torch

from ..utils import hostcache, profiling
from ..utils.rows import Rows
from . import cuda_build, ipc, ipc_slab

#: launches of the frame inverse since the last reset (set it to 0 to
#: reset)
launches = 0
#: launches of the forward kernel since the last reset
fwd_launches = 0

# each 4096^2 plane stack is 0.6 GB of host RAM: hold at most two
_PLANES_CACHE = hostcache.BoundedCache(2, "kernel_planes")


def kernel_planes_frame(kernel, nside, nborder=4):
    """Host-side (9, nside, nside) float32 kernel planes, border ZERO.

    ``kernel`` is the (3, 3, na, na) active-region IPC kernel; plane
    ``3 * (1 + dy) + (1 + dx)`` holds ``kernel[1 + dy, 1 + dx]``.  The
    zero border is the zero-fill edge of the reference stencil: a tap
    that sources a border pixel multiplies a zero weight.  Cached per
    cal pack (id-keyed; the value holds a strong reference to
    ``kernel`` so a recycled id cannot alias it).  A cache miss is the
    span ``host.kernel_planes``.
    """
    na = kernel.shape[-1]
    ck = (id(kernel), nside, nborder)
    hit = _PLANES_CACHE.get(ck)
    if hit is not None:
        return hit[0]
    with profiling.span("host.kernel_planes"):
        kp = np.zeros((9, nside, nside), np.float32)
        kp[:, nborder : nborder + na, nborder : nborder + na] = np.asarray(
            kernel, np.float32
        ).reshape(9, na, na)
    return _PLANES_CACHE.put(ck, (kp, kernel))[0]


def bytes_moved(ngrp, nside):
    """Least bytes the function must move: the cube, 9 planes and the
    gain read once, the cube written once."""
    return 4 * nside * nside * (2 * ngrp + 9 + 1)


def ipc_rev2_rows_plain(data, planes, gain, nborder=4, row0=0, lo=0, hi=0):
    """Plain PyTorch version of :func:`ipc_rev2_rows`: :func:`.ipc.ipc_rev`
    on the whole slab (zero fill beyond it), the planes viewed as the
    (3, 3, h, nside) kernel, the frame's border passed through, trimmed
    to the slab's own rows."""
    h, nside = data.shape[-2:]
    r = Rows(row0, h, lo, hi).checked(nside, nborder)
    res = ipc.ipc_rev(data, planes.view(3, 3, h, nside), order=2, gain=gain)
    mask = torch.zeros((h, nside), dtype=torch.bool, device=data.device)
    mask[r.own_active(nside, nborder), nborder : nside - nborder] = True
    return torch.where(mask, res, data)[:, r.own]


def ipc_rev2_rows(data, planes, gain, nborder=4, row0=0, lo=0, hi=0):
    """Order-2 IPC inverse of a row slab of the raw frame cube.

    ``data`` is the (ngrp, h, nside) float32 slab whose first row is the
    frame's row ``row0``, of which the first ``lo`` and the last ``hi``
    rows are halo (other slabs' rows, at least ``ipc_slab.NEUMANN_EXT``
    of them where the slab has a neighbour); ``planes`` the same rows of
    :func:`kernel_planes_frame`'s (9, nside, nside) planes, ``gain`` of
    the (nside, nside) gain.  Returns the (ngrp, h - lo - hi, nside)
    own rows: the inverse on the frame's active pixels, the rest passed
    through.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (no launch when the slab holds no active row).
    """
    if data.device.type == "cpu":
        return ipc_rev2_rows_plain(data, planes, gain, nborder, row0, lo, hi)
    global launches
    ngrp, h, nside = data.shape
    req = cuda_build.require
    req(data, "data", torch.float32, (ngrp, h, nside))
    req(planes, "planes", torch.float32, (9, h, nside))
    req(gain, "gain", torch.float32, (h, nside))
    r = Rows(row0, h, lo, hi).checked(nside, nborder)
    own, act = r.own, r.own_active(nside, nborder)
    out = torch.empty((ngrp, own.stop - own.start, nside), dtype=data.dtype,
                      device=data.device)
    if act.stop == act.start:
        out.copy_(data[:, own])
        return out
    cols = slice(nborder, nside - nborder)
    ext = ipc_slab.NEUMANN_EXT
    oact = slice(act.start - lo, act.stop - lo)
    ipc_slab.launch(
        data[:, act, cols], out[:, oact, cols], planes[:, act, cols], gain[act, cols],
        data[:, own], out, nborder, min(act.start, ext), min(h - act.stop, ext),
        oact.start, out.shape[1] - oact.stop, order=ipc_slab.NEUMANN)
    launches += 1
    return out


def ipc_rev2_frame_plain(data, planes, gain, nborder=4):
    """Plain PyTorch version of :func:`ipc_rev2_frame` (same inputs/outputs):
    :func:`.ipc.ipc_rev` on the whole frame, the planes viewed as the
    (3, 3, nside, nside) kernel, border passed through."""
    return ipc_rev2_rows_plain(data, planes, gain, nborder)


def ipc_rev2_frame(data, planes, gain, nborder=4):
    """Order-2 IPC inverse on the raw (ngrp, nside, nside) float32 cube,
    border passthrough: :func:`ipc_rev2_rows` on the whole frame.
    ``planes`` is the (9, nside, nside) output of
    :func:`kernel_planes_frame`; ``gain`` is (nside, nside).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel:
    the slab kernel in the Neumann order on the active views of the
    frame, its planes and its gain, the border copied by the same
    launch.
    """
    return ipc_rev2_rows(data, planes, gain, nborder)


def rows_bytes_moved(ngrp, h, nside, lo=0, hi=0):
    """Least bytes :func:`ipc_rev2_rows` must move: the slab, its planes
    and gain read once, its own rows written once."""
    return 4 * nside * (ngrp * (2 * h - lo - hi) + 10 * h)


def fwd_bytes_moved(ngrp, na, has_gain=False):
    """Least bytes the forward function must move: the cube read and
    written once, the nine planes (and the gain) read once."""
    return 4 * na * na * (2 * ngrp + 9 + int(has_gain))


def ipc_fwd_cube(cube, kernel, gain=None):
    """One forward IPC application on a (ngrp, na, na) float32 cube:
    :func:`.ipc.ipc_fwd` as one fused pass.  ``kernel`` is the
    (3, 3, na, na) IPC kernel, ``gain`` an optional (na, na) plane (the
    cube is then in DN: ``g^-1 K g``).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel.
    """
    if cube.device.type == "cpu":
        return ipc.ipc_fwd(cube, kernel, gain)
    global fwd_launches
    ngrp, na, _ = cube.shape
    req = cuda_build.require
    req(cube, "cube", torch.float32, (ngrp, na, na))
    req(kernel, "kernel", torch.float32, (3, 3, na, na))
    if gain is not None:
        req(gain, "gain", torch.float32, (na, na))
    out = torch.empty_like(cube)
    lib = cuda_build.library("ipc_fwd.cu")
    with torch.cuda.device(cube.device):
        err = lib.ipc_fwd_cube_launch(
            cube.data_ptr(), kernel.data_ptr(),
            None if gain is None else gain.data_ptr(), out.data_ptr(),
            ngrp, na, cuda_build.stream_ptr(cube),
        )
    cuda_build.check(err, "ipc_fwd_cube_launch")
    fwd_launches += 1
    return out
