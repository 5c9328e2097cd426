"""Hand-written CUDA kernels for the order-2 IPC inverse on the
active-region cube: blocked, streaming, and the fused full-frame form.

Replaces the slab half of the TPU module ``ops/ipc_pallas.py`` of the
JAX package: ``ipc_rev2_cube_blocked`` (``IPC_BACKEND: pallas``),
``ipc_rev2_cube_stream`` (``pallas-stream``) and the wrapper
``correct_cube_fused``.  All three compute, for every group,

    y = cube * gain;  a = K y;  b = K a;  out = ((3 y - 3 a) + b) / gain

where ``K x`` sums ``shift(x * K_t)`` over :data:`TAPS` in order (the
first product starts the sum; source-indexed weights; zero fill).  This
is another order of summation than the frame kernel's Neumann recursion
(:mod:`.ipc_cuda`), so the two routes differ in the last bits.

The kernels (``csrc/ipc_slab.cu``) take row pitches, so they read the
raw (3, 3, na, na) IPC kernel or the pre-padded (9, rows_in, width)
buffer of :func:`kernel_planes_padded` in place, and the fused form
reads the active view of the full frame with no slice copy.  The padded
slab layout itself (science at ``[th:th+na, 2:2+na]``) is the TPU
kernels' block geometry; here it is only a layout the entry points
accept, for parity with the reference's contract.

Plain twin: :func:`ipc_rev2_plain`.  A CPU tensor takes the twin; a CUDA
tensor launches the kernel, with which the twin agrees bit for bit.
Bound: bytes (:func:`bytes_moved`), 1.47 GB at 6 groups of 4088^2.
"""

import numpy as np
import torch

from ..utils import hostcache
from . import cuda_build
from .ipc import shift_zero

#: tap order: index t corresponds to (dy, dx) = TAPS[t]
TAPS = [
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 0), (0, 1),
    (1, -1), (1, 0), (1, 1),
]

#: launches of the blocked kernel since the last reset (by
#: :func:`ipc_rev2_cube_blocked` or :func:`correct_cube_fused`)
blocked_launches = 0
#: launches of the streaming kernel since the last reset
stream_launches = 0
#: fused full-frame launches (of the blocked kernel) since the last reset
fused_launches = 0


def _pad_geom(na, th):
    """(rows_out, width, n_tiles, rows_in) of the padded slab layout."""
    rows_out = ((na + th - 1) // th) * th
    width = ((na + 4 + 127) // 128) * 128
    n_tiles = rows_out // th
    rows_in = (n_tiles + 2) * th
    return rows_out, width, n_tiles, rows_in


# each 4096^2 padded slab is 0.6 GB of host RAM: hold at most two
_PAD_CACHE = hostcache.BoundedCache(2)


def kernel_planes_padded(kernel, th=32):
    """Host-side pre-padded (9, rows_in, width) float32 kernel planes.

    ``kernel`` is the (3, 3, na, na) IPC kernel; plane ``t`` holds
    ``kernel[1 + dy, 1 + dx]`` for ``(dy, dx) = TAPS[t]`` at
    ``[th:th+na, 2:2+na]``, zero elsewhere.  Cached per cal pack
    (id-keyed; the value holds a strong reference to ``kernel`` so a
    recycled id cannot alias it).  Pass the result as the ``kernel``
    argument of the entry points called with the same ``th``.
    """
    na = kernel.shape[-1]
    ck = (id(kernel), th)
    hit = _PAD_CACHE.get(ck)
    if hit is not None:
        return hit[0]
    _, width, _, rows_in = _pad_geom(na, th)
    kp = np.zeros((9, rows_in, width), np.float32)
    kp[:, th : th + na, 2 : 2 + na] = np.asarray(
        kernel, np.float32
    ).reshape(9, na, na)
    return _PAD_CACHE.put(ck, (kp, kernel))[0]


def _planes_view(kernel, na, th):
    """The nine (na, na) weight planes of ``kernel`` as a (9, na, na)
    view: the raw (3, 3, na, na) tensor, or the science window of a
    pre-padded (9, rows_in, width) one, whose shape must match this
    call's slab geometry (the same ``th``)."""
    if kernel.ndim == 3:
        _, width, _, rows_in = _pad_geom(na, th)
        if tuple(kernel.shape) != (9, rows_in, width):
            raise ValueError(
                f"pre-padded kernel shape {tuple(kernel.shape)} does not match "
                f"slab geometry {(9, rows_in, width)} (built with a "
                f"different th?)"
            )
        return kernel[:, th : th + na, 2 : 2 + na]
    if tuple(kernel.shape) != (3, 3, na, na):
        raise ValueError(
            f"kernel: expected shape {(3, 3, na, na)} or the pre-padded "
            f"slab form, got {tuple(kernel.shape)}"
        )
    return kernel.reshape(9, na, na)


def bytes_moved(ngrp, na, has_gain=True):
    """Least bytes the function must move: the cube read and written
    once, the nine planes (and the gain) read once."""
    return 4 * na * na * (2 * ngrp + 9 + int(has_gain))


def fused_bytes_moved(ngrp, nside, nborder, has_gain=True):
    """As :func:`bytes_moved` for the full-frame form: the whole frame in
    and out, planes and gain on the active region."""
    na = nside - 2 * nborder
    return 4 * (2 * ngrp * nside * nside + (9 + int(has_gain)) * na * na)


def _fwd_taps(x, planes):
    """``K x``: the shifted products summed over TAPS in order, the
    first term starting the sum."""
    out = None
    for t, (dy, dx) in enumerate(TAPS):
        term = shift_zero(x * planes[t], dy, dx)
        out = term if out is None else out + term
    return out


def ipc_rev2_plain(cube, planes, gain=None):
    """Plain PyTorch version of the slab kernels: ``cube`` (ngrp, na,
    na), ``planes`` the (9, na, na) weights in TAPS order, ``gain``
    (na, na) or None."""
    y = cube if gain is None else cube * gain
    a = _fwd_taps(y, planes)
    b = _fwd_taps(a, planes)
    out = (3.0 * y - 3.0 * a) + b
    if gain is not None:
        out = out / gain
    return out


def _check_gain(gain, na):
    """An (na, na) float32 CUDA plane whose rows are contiguous (a view
    of the full-frame gain is read in place through its row pitch)."""
    if gain is None:
        return
    if gain.device.type != "cuda" or gain.dtype != torch.float32:
        raise ValueError(f"gain: expected a float32 CUDA tensor, got "
                         f"{gain.dtype} on {gain.device}")
    if tuple(gain.shape) != (na, na) or gain.stride(-1) != 1:
        raise ValueError(f"gain: expected shape {(na, na)} with contiguous "
                         f"rows, got {tuple(gain.shape)}, strides {gain.stride()}")


def _slab_args(src, dst, planes, gain, ngrp, na):
    """The kernels' common argument list: pointer, group / plane stride
    and row pitch of the cube in, the cube out and the planes; pointer
    and pitch of the gain."""
    return (
        src.data_ptr(), src.stride(0), src.stride(1),
        dst.data_ptr(), dst.stride(0), dst.stride(1),
        planes.data_ptr(), planes.stride(0), planes.stride(1),
        None if gain is None else gain.data_ptr(),
        0 if gain is None else gain.stride(0),
        ngrp, na,
    )


def _require_inputs(cube, kernel, gain, na, th):
    ngrp = cube.shape[0]
    cuda_build.require(cube, "cube", torch.float32, (ngrp, na, na))
    cuda_build.require(kernel, "kernel", torch.float32, kernel.shape)
    planes = _planes_view(kernel, na, th)
    _check_gain(gain, na)
    return ngrp, planes


def ipc_rev2_cube_blocked(cube, kernel, gain=None, th=16):
    """Order-2 IPC inverse of a (ngrp, na, na) float32 cube, 2-D tiles
    with their own halo.  ``kernel`` is the raw (3, 3, na, na) tensor or
    the pre-padded one built with this ``th`` (which only names the slab
    geometry to check it against); ``gain`` an optional (na, na) plane
    (the cube is then in DN).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    na = cube.shape[-1]
    if cube.device.type == "cpu":
        return ipc_rev2_plain(cube, _planes_view(kernel, na, th), gain)
    global blocked_launches
    ngrp, planes = _require_inputs(cube, kernel, gain, na, th)
    out = torch.empty_like(cube)
    lib = cuda_build.library("ipc_slab.cu")
    with torch.cuda.device(cube.device):
        err = lib.ipc_slab_blocked_launch(
            *_slab_args(cube, out, planes, gain, ngrp, na),
            None, None, 0, 0, cuda_build.stream_ptr(cube),
        )
    cuda_build.check(err, "ipc_slab_blocked_launch")
    blocked_launches += 1
    return out


def ipc_rev2_cube_stream(cube, kernel, gain=None, th=16):
    """The same function as :func:`ipc_rev2_cube_blocked`, bit for bit,
    with every input row of a column strip read once: a ring of rows in
    shared memory carries the halo down the strip."""
    na = cube.shape[-1]
    if cube.device.type == "cpu":
        return ipc_rev2_plain(cube, _planes_view(kernel, na, th), gain)
    global stream_launches
    ngrp, planes = _require_inputs(cube, kernel, gain, na, th)
    out = torch.empty_like(cube)
    lib = cuda_build.library("ipc_slab.cu")
    with torch.cuda.device(cube.device):
        err = lib.ipc_slab_stream_launch(
            *_slab_args(cube, out, planes, gain, ngrp, na),
            cuda_build.stream_ptr(cube),
        )
    cuda_build.check(err, "ipc_slab_stream_launch")
    stream_launches += 1
    return out


def _nborder(data, kernel, nborder):
    if nborder is not None:
        return nborder
    if kernel.ndim == 3:
        raise ValueError("nborder is required with a pre-padded kernel")
    return (data.shape[-2] - kernel.shape[-1]) // 2


def correct_cube_plain(data, kernel, gain=None, nborder=None, th=8):
    """Plain PyTorch version of :func:`correct_cube_fused`: the twin on
    the active slice, merged into a copy of the frame."""
    nb = _nborder(data, kernel, nborder)
    ny = data.shape[-2]
    na = ny - 2 * nb
    corr = ipc_rev2_plain(data[:, nb : ny - nb, nb : ny - nb],
                          _planes_view(kernel, na, th), gain)
    if nb == 0:
        return corr
    out = data.clone()
    out[:, nb : ny - nb, nb : ny - nb] = corr
    return out


def correct_cube_fused(data, kernel, gain=None, nborder=None, th=8):
    """IPC-deconvolve the active region of a (ngrp, ny, ny) float32
    frame cube; the ``nborder``-wide border passes through unchanged.
    ``kernel`` and ``gain`` cover the active region, as for
    :func:`ipc_rev2_cube_blocked`.  Returns a new tensor.

    On a CUDA tensor this is one launch of the blocked kernel on the
    frame in place: the active view is read through the frame's row
    pitch, the result lands in the output frame's active region, and
    extra thread blocks of the same launch copy the border."""
    if data.device.type == "cpu":
        return correct_cube_plain(data, kernel, gain, nborder, th)
    global blocked_launches, fused_launches
    nb = _nborder(data, kernel, nborder)
    ngrp, ny, _ = data.shape
    na = ny - 2 * nb
    if nb < 0 or na <= 0:
        raise ValueError(f"nborder {nb} does not fit a frame of {ny}")
    cuda_build.require(data, "data", torch.float32, (ngrp, ny, ny))
    cuda_build.require(kernel, "kernel", torch.float32, kernel.shape)
    planes = _planes_view(kernel, na, th)
    _check_gain(gain, na)
    out = torch.empty_like(data)
    src = data[:, nb : ny - nb, nb : ny - nb]
    dst = out[:, nb : ny - nb, nb : ny - nb]
    lib = cuda_build.library("ipc_slab.cu")
    with torch.cuda.device(data.device):
        err = lib.ipc_slab_blocked_launch(
            *_slab_args(src, dst, planes, gain, ngrp, na),
            data.data_ptr(), out.data_ptr(), ny, nb,
            cuda_build.stream_ptr(data),
        )
    cuda_build.check(err, "ipc_slab_blocked_launch")
    blocked_launches += 1
    fused_launches += 1
    return out
