"""Hand-written CUDA kernel for the order-2 IPC inverse on the
active-region cube, behind the three slab entry points of the TPU module
and the frame inverse of :mod:`.ipc_cuda`.

Replaces the slab half of the TPU module ``ops/ipc_pallas.py`` of the
JAX package: ``ipc_rev2_cube_blocked`` (``IPC_BACKEND: pallas``),
``ipc_rev2_cube_stream`` (``pallas-stream``) and the wrapper
``correct_cube_fused``.  All three compute, for every group,

    y = cube * gain;  a = K y;  b = K a;  out = ((3 y - 3 a) + b) / gain

where ``K x`` sums ``shift(x * K_t)`` over :data:`TAPS` in order (the
first product starts the sum; source-indexed weights; zero fill).  This
is another order of summation than the frame inverse's Neumann
recursion (:mod:`.ipc_cuda`), so the two routes differ in the last bits.
The kernel is compiled for both orders (:data:`SLAB`, :data:`NEUMANN`):
:func:`.ipc_cuda.ipc_rev2_frame` launches it in the Neumann order.

The TPU's blocked and streaming traversals exist for its VMEM windows;
here one kernel (``csrc/ipc_slab.cu``) serves every entry point: a warp
owns a strip of 64 columns, two a lane (60 written, :data:`STRIP`),
walks a segment of rows upward with the window of partial tap sums in
registers, and moves products between lanes by shuffles.  :func:`plan` cuts the cube
into strips, segments and group chunks.  The kernel takes row pitches,
so it reads the raw (3, 3, na, na) IPC kernel or the pre-padded (9,
rows_in, width) buffer of :func:`kernel_planes_padded` in place, and the
frame forms (:func:`correct_cube_fused`, :func:`correct_cube_stream`)
read the active view of the full frame and write the output frame's
active region, the border copied by the same launch.  The padded slab
layout itself (science at ``[th:th+na, 2:2+na]``) is the TPU kernels'
block geometry; here it is only a layout the entry points accept, for
parity with the reference's contract.

The frame forms take a row slab of the frame as well (``row0``, ``lo``,
``hi``; the row-sharded calibration of :mod:`..parallel.spatial`): the
same launch with the slab's row count, its halo rows read as sources;
the whole frame is the slab ``row0 = lo = hi = 0``
(:class:`..utils.rows.Rows`).

Plain twin: :func:`ipc_rev2_plain`.  A CPU tensor takes the twin; a CUDA
tensor launches the kernel, with which the twin agrees bit for bit.
Bound: bytes (:func:`bytes_moved`), 1.47 GB at 6 groups of 4088^2.
"""

import collections
import ctypes

import numpy as np
import torch

from ..utils import hostcache
from ..utils.rows import Rows
from . import cuda_build
from .ipc import shift_zero

#: tap order: index t corresponds to (dy, dx) = TAPS[t]
TAPS = [
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 0), (0, 1),
    (1, -1), (1, 0), (1, 1),
]

#: launches by :func:`ipc_rev2_cube_blocked` and :func:`correct_cube_fused`
#: (the TPU module's fused form wraps the blocked one) since the last reset
blocked_launches = 0
#: launches by :func:`ipc_rev2_cube_stream` and :func:`correct_cube_stream`
stream_launches = 0
#: launches by :func:`correct_cube_fused`
fused_launches = 0

#: columns a warp reads: 32 lanes of two adjacent columns each
WIDTH = 64
#: output columns of a warp: less two halo columns on each side
STRIP = WIDTH - 4
#: warps (strips) of a CTA
WARPS = 4
#: most groups one pass holds in registers (the kernel is compiled for 1..8)
GROUP_CHUNK = 8
#: shortest segment, so the warm-up stays under a fifth of the rows read
MIN_SEG = 16
#: CTAs an H100 holds at once, when the device is not asked (132 SMs x 3)
RESIDENT_H100 = 396
#: CTAs of a frame-form launch that copy the border beside the segments
BORDER_CTAS = 8
#: the kernel's orders of summation: this module's entry points, and the
#: frame inverse of :mod:`.ipc_cuda` (the Neumann recursion)
SLAB, NEUMANN = 0, 1
#: border rows and columns around the active region that the Neumann
#: order reads from the frame (its second product's sources' sources)
NEUMANN_EXT = 2


#: how the kernel cuts a (ngrp, na, na) cube: ``strip`` output columns
#: per warp, ``seg`` output rows per segment (``nseg`` of them), ``chunk``
#: groups per pass (``nchunks`` passes, each reading the planes), and the
#: ``grid`` of CTAs (``ctas_x`` across)
Plan = collections.namedtuple(
    "Plan", ("strip", "seg", "nseg", "chunk", "nchunks", "ctas_x", "grid"))


def plan(na, ngrp, resident=RESIDENT_H100, nrows=None):
    """The kernel's partition of a (ngrp, na, na) cube, or of ``nrows``
    rows of ``na`` columns, given the CTAs the card holds at once
    (``resident``).  Groups split into the fewest chunks of at most
    :data:`GROUP_CHUNK`, as even as they go; segments are as long as one
    wave of resident CTAs allows (each reads 4 warm-up rows, 2 above and
    2 below what it writes), and no shorter than :data:`MIN_SEG` rows."""
    nr = na if nrows is None else nrows
    if na < 1 or nr < 1 or ngrp < 1:
        raise ValueError(f"plan: na {na}, nrows {nr} and ngrp {ngrp} must be positive")
    nchunks = -(-ngrp // GROUP_CHUNK)
    chunk = -(-ngrp // nchunks)
    strips = -(-na // STRIP)
    ctas_x = -(-strips // WARPS)
    nseg = max(1, min(resident // (ctas_x * nchunks), nr // MIN_SEG))
    seg = -(-nr // nseg)
    nseg = -(-nr // seg)
    return Plan(STRIP, seg, nseg, chunk, nchunks, ctas_x, ctas_x * nseg * nchunks)


def reread_share(na, ngrp, resident=RESIDENT_H100, ext=0):
    """Elements the plan's warps load beyond one read of each input, as
    a share of :func:`bytes_moved` (with a gain): the halo columns of
    every strip (4 of 64) and the warm-up rows of every segment, on
    the cube, and on the planes and gain once per chunk.  Neighbouring
    warps of a CTA load the same halo columns at about the same time, so
    the caches serve most of that part.  ``ext``: rows and columns read
    around the active region (the Neumann order on a frame reads
    :data:`NEUMANN_EXT`)."""
    p = plan(na, ngrp, resident)
    cols = sum(min(na + ext, STRIP * i + STRIP + 2) - max(-ext, STRIP * i - 2)
               for i in range(-(-na // STRIP)))
    rows = sum(min(na + ext, min(r + p.seg, na) + 2) - max(-ext, r - 2)
               for r in range(0, na, p.seg))
    loaded = (ngrp + 10 * p.nchunks) * cols * rows
    return (loaded - (ngrp + 10) * na * na) / ((2 * ngrp + 10) * na * na)


def _pad_geom(na, th):
    """(rows_out, width, n_tiles, rows_in) of the padded slab layout."""
    rows_out = ((na + th - 1) // th) * th
    width = ((na + 4 + 127) // 128) * 128
    n_tiles = rows_out // th
    rows_in = (n_tiles + 2) * th
    return rows_out, width, n_tiles, rows_in


# each 4096^2 padded slab is 0.6 GB of host RAM: hold at most two
_PAD_CACHE = hostcache.BoundedCache(2, "slab_pad")


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


def _check_gain(gain, shape):
    """A float32 CUDA plane of ``shape`` whose rows are contiguous (a view
    of the full-frame gain is read in place through its row pitch)."""
    if gain is None:
        return
    if gain.device.type != "cuda" or gain.dtype != torch.float32:
        raise ValueError(f"gain: expected a float32 CUDA tensor, got "
                         f"{gain.dtype} on {gain.device}")
    if tuple(gain.shape) != tuple(shape) or gain.stride(-1) != 1:
        raise ValueError(f"gain: expected shape {tuple(shape)} with contiguous "
                         f"rows, got {tuple(gain.shape)}, strides {gain.stride()}")


def _require_inputs(cube, kernel, gain, na, th):
    ngrp = cube.shape[0]
    cuda_build.require(cube, "cube", torch.float32, (ngrp, na, na))
    cuda_build.require(kernel, "kernel", torch.float32, kernel.shape)
    planes = _planes_view(kernel, na, th)
    _check_gain(gain, (na, na))
    return ngrp, planes


_RESIDENT = {}


def _resident(lib, device, chunk, order=SLAB):
    """CTAs of the kernel compiled for ``chunk`` groups and ``order``
    that ``device`` holds at once (asked once per device, chunk and
    order)."""
    key = (device.index, chunk, order)
    if key not in _RESIDENT:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.ipc_slab_resident(chunk, order, ctypes.byref(n))
        cuda_build.check(err, "ipc_slab_resident")
        _RESIDENT[key] = n.value
    return _RESIDENT[key]


def launch(src, dst, planes, gain, frame_in=None, frame_out=None, nborder=0,
           ext_lo=0, ext_hi=0, top=0, bot=0, order=SLAB):
    """One launch of the kernel on the (ngrp, nrows, na) views ``src`` ->
    ``dst`` (each row contiguous), summing in ``order``.  Without
    ``frame_in`` / ``frame_out`` (a cube) nothing else is read.  With
    them (the (ngrp, rows, nside) frame rows that the views lie in, each
    row contiguous), the walk reads ``ext_lo`` rows above and ``ext_hi``
    below the views (at most :data:`NEUMANN_EXT`) through ``src``,
    ``planes`` and ``gain``, and, in the Neumann order, ``min(nborder,
    NEUMANN_EXT)`` columns on each side; the extra CTAs copy the border
    of ``frame_in`` into ``frame_out``: its first ``top`` and last
    ``bot`` rows whole, ``nborder`` columns of each row between."""
    ngrp, nr, na = src.shape
    lib = cuda_build.library("ipc_slab.cu")
    border = BORDER_CTAS if frame_in is not None and nborder > 0 else 0
    resident = _resident(lib, src.device, plan(na, ngrp).chunk, order)
    p = plan(na, ngrp, max(1, resident - border), nrows=nr)
    frame = frame_in is not None
    with torch.cuda.device(src.device):
        err = lib.ipc_slab_launch(
            src.data_ptr(), src.stride(0), src.stride(1),
            dst.data_ptr(), dst.stride(0), dst.stride(1),
            planes.data_ptr(), planes.stride(0), planes.stride(1),
            None if gain is None else gain.data_ptr(),
            0 if gain is None else gain.stride(0), ngrp, na, nr, ext_lo, ext_hi,
            frame_in.data_ptr() if frame else None, frame_in.stride(0) if frame else 0,
            frame_out.data_ptr() if frame else None, frame_out.stride(0) if frame else 0,
            frame_in.shape[-2] if frame else 0, frame_in.shape[-1] if frame else 0,
            nborder, top, bot, border, p.seg, p.chunk, order, cuda_build.stream_ptr(src),
        )
    cuda_build.check(err, "ipc_slab_launch")


def _cube(cube, kernel, gain, th):
    """One launch on a contiguous (ngrp, na, na) cube."""
    na = cube.shape[-1]
    _, planes = _require_inputs(cube, kernel, gain, na, th)
    out = torch.empty_like(cube)
    launch(cube, out, planes, gain)
    return out


def ipc_rev2_cube_blocked(cube, kernel, gain=None, th=16):
    """Order-2 IPC inverse of a (ngrp, na, na) float32 cube.  ``kernel``
    is the raw (3, 3, na, na) tensor or the pre-padded one built with
    this ``th`` (which only names the slab geometry to check it
    against); ``gain`` an optional (na, na) plane (the cube is then in
    DN).  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel."""
    if cube.device.type == "cpu":
        return ipc_rev2_plain(cube, _planes_view(kernel, cube.shape[-1], th), gain)
    global blocked_launches
    out = _cube(cube, kernel, gain, th)
    blocked_launches += 1
    return out


def ipc_rev2_cube_stream(cube, kernel, gain=None, th=16):
    """The same function as :func:`ipc_rev2_cube_blocked`, bit for bit:
    the reference's single-read streaming form.  On the card both are
    one launch of the one kernel, which streams rows itself."""
    if cube.device.type == "cpu":
        return ipc_rev2_plain(cube, _planes_view(kernel, cube.shape[-1], th), gain)
    global stream_launches
    out = _cube(cube, kernel, gain, th)
    stream_launches += 1
    return out


def _nborder(data, kernel, nborder):
    if nborder is not None:
        return nborder
    if kernel.ndim == 3:
        raise ValueError("nborder is required with a pre-padded kernel")
    return (data.shape[-1] - kernel.shape[-1]) // 2


def _frame_rows(data, kernel, nborder, row0, lo, hi):
    """(nborder, :class:`Rows` of the slab ``data``, its rows that are
    active rows of the frame (halo included), its own such rows)."""
    nb = _nborder(data, kernel, nborder)
    nside = data.shape[-1]
    r = Rows(row0, data.shape[-2], lo, hi).checked(nside, nb)
    return nb, r, r.active(nside, nb), r.own_active(nside, nb)


def correct_cube_plain(data, kernel, gain=None, nborder=None, th=8, row0=0, lo=0, hi=0):
    """Plain PyTorch version of :func:`correct_cube_fused`: the twin on
    the active rows and columns (a slab's halo rows included, zero
    beyond them), merged into a copy of the frame, trimmed to its own
    rows."""
    nb, r, ra, _ = _frame_rows(data, kernel, nborder, row0, lo, hi)
    nside = data.shape[-1]
    cols = slice(nb, nside - nb)
    out = data.clone()
    if ra.stop > ra.start:
        g = r.active_span(nside, nb)
        planes = _planes_view(kernel, nside - 2 * nb, th)[:, g]
        out[:, ra, cols] = ipc_rev2_plain(data[:, ra, cols], planes, gain)
    return out[:, r.own]


def _correct_frame(data, kernel, gain, nborder, th, row0, lo, hi):
    """One launch on the frame, or a row slab of it, in place: the
    active view of its own rows read through the row pitch (the active
    halo rows read as sources), the result in the output's active
    region, the border of its own rows copied by extra CTAs of the same
    launch; returns (own rows, launched)."""
    nb, r, ra, act = _frame_rows(data, kernel, nborder, row0, lo, hi)
    ngrp, h, nside = data.shape
    cuda_build.require(data, "data", torch.float32, (ngrp, h, nside))
    cuda_build.require(kernel, "kernel", torch.float32, kernel.shape)
    _check_gain(gain, (ra.stop - ra.start, nside - 2 * nb))
    own = r.own
    out = torch.empty((ngrp, own.stop - own.start, nside), dtype=data.dtype,
                      device=data.device)
    if act.stop == act.start:
        out.copy_(data[:, own])
        return out, False
    cols = slice(nb, nside - nb)
    g0 = row0 + act.start - nb
    planes = _planes_view(kernel, nside - 2 * nb, th)[:, g0 : g0 + act.stop - act.start]
    oact = slice(act.start - lo, act.stop - lo)
    launch(data[:, act, cols], out[:, oact, cols], planes,
           None if gain is None else gain[act.start - ra.start : act.stop - ra.start],
           data[:, own], out, nb, min(act.start - ra.start, NEUMANN_EXT),
           min(ra.stop - act.stop, NEUMANN_EXT), oact.start, out.shape[1] - oact.stop)
    return out, True


def correct_cube_fused(data, kernel, gain=None, nborder=None, th=8, row0=0, lo=0, hi=0):
    """IPC-deconvolve the active region of a (ngrp, ny, ny) float32
    frame cube; the ``nborder``-wide border passes through unchanged.
    ``kernel`` covers the active region, as for
    :func:`ipc_rev2_cube_blocked`; ``gain`` (optional) the active
    region.  Returns a new tensor.

    A row slab of the frame (the row-sharded calibration): ``data`` the
    (ngrp, h, ny) slab whose first row is the frame's row ``row0``, its
    first ``lo`` and last ``hi`` rows halo (at least
    :data:`NEUMANN_EXT` of them where it has a neighbour), ``gain`` the
    active columns of the slab's active rows (halo included).  Returns
    the (ngrp, h - lo - hi, ny) own rows.

    On a CUDA tensor this is one launch on the frame in place: the
    active view is read through the frame's row pitch, the result lands
    in the output frame's active region, and extra thread blocks of the
    same launch copy the border (no launch when a slab holds no active
    row)."""
    if data.device.type == "cpu":
        return correct_cube_plain(data, kernel, gain, nborder, th, row0, lo, hi)
    global blocked_launches, fused_launches
    out, launched = _correct_frame(data, kernel, gain, nborder, th, row0, lo, hi)
    if launched:
        blocked_launches += 1
        fused_launches += 1
    return out


def correct_cube_stream(data, kernel, gain=None, nborder=None, th=8, row0=0, lo=0, hi=0):
    """:func:`correct_cube_fused` over the streaming entry point: the
    ``pallas-stream`` route's frame form, one launch counted as one of
    :func:`ipc_rev2_cube_stream`."""
    if data.device.type == "cpu":
        return correct_cube_plain(data, kernel, gain, nborder, th, row0, lo, hi)
    global stream_launches
    out, launched = _correct_frame(data, kernel, gain, nborder, th, row0, lo, hi)
    if launched:
        stream_launches += 1
    return out
