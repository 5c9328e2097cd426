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

from ..utils import hostcache
from . import cuda_build, ipc, ipc_slab

#: launches of the frame inverse since the last reset (set it to 0 to
#: reset)
launches = 0
#: launches of the forward kernel since the last reset
fwd_launches = 0

# each 4096^2 plane stack is 0.6 GB of host RAM: hold at most two
_PLANES_CACHE = hostcache.BoundedCache(2)


def kernel_planes_frame(kernel, nside, nborder=4):
    """Host-side (9, nside, nside) float32 kernel planes, border ZERO.

    ``kernel`` is the (3, 3, na, na) active-region IPC kernel; plane
    ``3 * (1 + dy) + (1 + dx)`` holds ``kernel[1 + dy, 1 + dx]``.  The
    zero border is the zero-fill edge of the reference stencil: a tap
    that sources a border pixel multiplies a zero weight.  Cached per
    cal pack (id-keyed; the value holds a strong reference to
    ``kernel`` so a recycled id cannot alias it).
    """
    na = kernel.shape[-1]
    ck = (id(kernel), nside, nborder)
    hit = _PLANES_CACHE.get(ck)
    if hit is not None:
        return hit[0]
    kp = np.zeros((9, nside, nside), np.float32)
    kp[:, nborder : nborder + na, nborder : nborder + na] = np.asarray(
        kernel, np.float32
    ).reshape(9, na, na)
    return _PLANES_CACHE.put(ck, (kp, kernel))[0]


def bytes_moved(ngrp, nside):
    """Least bytes the function must move: the cube, 9 planes and the
    gain read once, the cube written once."""
    return 4 * nside * nside * (2 * ngrp + 9 + 1)


def ipc_rev2_frame_plain(data, planes, gain, nborder=4):
    """Plain PyTorch version of :func:`ipc_rev2_frame` (same inputs/outputs):
    :func:`.ipc.ipc_rev` on the whole frame, the planes viewed as the
    (3, 3, nside, nside) kernel, border passed through."""
    nb = nborder
    nside = data.shape[-1]
    res = ipc.ipc_rev(data, planes.view(3, 3, nside, nside), order=2, gain=gain)
    act = torch.zeros((nside, nside), dtype=torch.bool, device=data.device)
    act[nb : nside - nb, nb : nside - nb] = True
    return torch.where(act, res, data)


def ipc_rev2_frame(data, planes, gain, nborder=4):
    """Order-2 IPC inverse on the raw (ngrp, nside, nside) float32 cube,
    border passthrough.  ``planes`` is the (9, nside, nside) output of
    :func:`kernel_planes_frame`; ``gain`` is (nside, nside).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel:
    the slab kernel in the Neumann order on the active views of the
    frame, its planes and its gain, the border copied by the same
    launch.
    """
    if data.device.type == "cpu":
        return ipc_rev2_frame_plain(data, planes, gain, nborder)
    global launches
    ngrp, nside, _ = data.shape
    req = cuda_build.require
    req(data, "data", torch.float32, (ngrp, nside, nside))
    req(planes, "planes", torch.float32, (9, nside, nside))
    req(gain, "gain", torch.float32, (nside, nside))
    if nborder < 0 or 2 * nborder >= nside:
        raise ValueError(f"nborder {nborder} leaves no active region in nside {nside}")
    out = torch.empty_like(data)
    act = slice(nborder, nside - nborder)
    ipc_slab.launch(data[:, act, act], out[:, act, act], planes[:, act, act],
                    gain[act, act], data, out, nborder, order=ipc_slab.NEUMANN)
    launches += 1
    return out


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
