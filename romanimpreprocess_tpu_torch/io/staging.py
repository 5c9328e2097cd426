"""The host <-> device boundary: the port's copies between host numpy
and device tensors, their wire formats, byte counts and staging cache.

Wire formats, the same both ways: uint16 counts (L1 cubes, amp33)
cross the bus as int16, 2 bytes a value, and are int32 on the device,
widened (:func:`stage`) and narrowed (:func:`u16_to_host`) there; uint32
DQ planes are int32 bit patterns on the device; float32 crosses as it
is, other host dtypes as float32.  Copies to the device count
``h2d_bytes``, the counted copies back (:func:`fetch`, :func:`to_host`)
``d2h_bytes`` (:mod:`..utils.profiling`).

A per-call copy to a CUDA device (``stage(..., cache=False)``, and so
:func:`place`) goes through page-locked host memory
(``h2d_pinned_bytes``): one block from torch's caching host allocator,
filled slice by slice along the leading axis (:data:`SLICE_BYTES`) by
``copy_`` on torch's intra-op threads, the wire format's conversion in
that one pass, each slice's device copy issued on the device's current
stream as soon as it is filled and not waited for.  The host has read
the caller's array when :func:`stage` returns; the allocator hands the
block out again only once its copies have run, and the kernels that
read the tensor queue behind them on the same stream.  A cal pack's
copies (a cached :func:`stage`'s miss, the IPC precal, the kernel
planes) run once, at set-up, through :func:`send` from pageable memory,
and hold no page-locked host memory.

A counted copy back from a CUDA device lands in page-locked host memory
from torch's caching host allocator (``d2h_pinned_bytes``): every copy
of a call is issued without waiting, then one sync of the current stream
hands out numpy views of the blocks.  A block goes back to the allocator
only when the last array viewing it is freed (the array holds the
tensor that owns it), so a block is never handed out while an earlier
result still views it.  From the CPU, :func:`fetch` shares the tensor's
storage as ``.cpu()`` does.

A cal pack's arrays are staged once per device through
:data:`_DEVICE_CACHE` (``device_arrays``), which the sim, the L1 -> L2
core and the noise engine share: a :class:`..utils.hostcache.PackCache`
bounded by device bytes (:func:`card_budget`: what the card has free
when a pack is admitted must stay above :data:`RESERVE`; no bound on the
CPU, where staging shares the host buffers).  :func:`..pipeline.l1_to_l2.prepare_inputs`
stages a pack as one unit (``stage(..., pack=...)``), with its IPC
precal and kernel planes, so that a pack is wholly resident or not at
all and a focal plane's 18 packs stay on the card together; an array
staged outside a pack (the sim's, the noise engine's) is a loose entry.
Nothing writes to a staged tensor: on the CPU it shares the host
array's buffer.
"""

import warnings

import numpy as np
import torch

from ..utils import hostcache, profiling

#: bytes of a card kept free of cached state for the work beside it: the
#: largest working set a call of the port takes beside its pack at
#: 4096^2 (the exposure lane's, about 11.4 GB), with room
RESERVE = 16 * 2**30


def card_budget(device, held):
    """Bytes of cached state ``device`` may hold, where the cache holds
    ``held`` there now: on a CUDA card, that and what the card has free
    (the driver's free memory and the blocks PyTorch's allocator keeps
    unused), less :data:`RESERVE`; None (no bound) elsewhere, where
    staging shares the host buffers."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free = torch.cuda.mem_get_info(dev)[0]
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return held + free + cached - RESERVE


# device copies of cal-pack arrays, keyed by (id, device); the value
# holds the numpy array so a recycled id cannot alias a stale entry
_DEVICE_CACHE = hostcache.PackCache("device_arrays", budget=card_budget)

#: the L1 -> L2 core's DQ outputs (int32 bit patterns, uint32 on the host)
_DQ_OUTPUTS = ("pdq", "rdq")


# the wire formats of the unsigned counts and DQ planes (bit patterns);
# any other dtype crosses as float32
_WIRE = {np.dtype(np.uint16): (np.int16, torch.int16),
         np.dtype(np.uint32): (np.int32, torch.int32)}

# host dtypes torch views in place (native byte order); others are
# converted by numpy first
_VIEWABLE = frozenset(np.dtype(t) for t in (
    np.bool_, np.uint8, np.int8, np.int16, np.int32, np.int64,
    np.float16, np.float32, np.float64))


def _source(a):
    """A host array as a CPU tensor viewing its buffer (uint16 as int16,
    uint32 as int32), and the torch dtype it crosses as."""
    arr = np.asarray(a)
    wire, dtype = _WIRE.get(arr.dtype, (np.float32, torch.float32))
    if arr.dtype in _WIRE:
        arr = arr.view(wire)
    if arr.dtype not in _VIEWABLE or any(s < 0 for s in arr.strides):
        arr = np.ascontiguousarray(arr, wire)
    with warnings.catch_warnings():
        # arrays read from ASDF are read-only; nothing writes to a staged
        # tensor, so the buffer is shared rather than copied
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        return torch.from_numpy(arr), dtype


def from_host(a):
    """A host array as a CPU tensor in its wire format, sharing its
    buffer where the format allows (uint16 as int16 here)."""
    src, dtype = _source(a)
    return src.to(dtype).contiguous()


def send(t, device):
    """The host tensor ``t`` copied to ``device`` from pageable memory,
    counted as ``h2d_bytes``."""
    profiling.count("h2d_bytes", t.nbytes)
    return t.to(device)


#: bytes of a slice of a per-call copy: the host fills slice g + 1 of
#: the page-locked block while the card copies slice g (one resultant of
#: a 4096^2 L1 cube, in int16, is 32 MiB)
SLICE_BYTES = 32 * 2**20


def _send_pinned(a, device):
    """The host array ``a`` in its wire format on the CUDA ``device``,
    through a recycled page-locked block: filled a slice at a time (the
    conversion to the wire format in the same pass), each slice's copy
    issued without a wait (``h2d_bytes``, ``h2d_pinned_bytes``)."""
    src, dtype = _source(a)
    out = torch.empty(src.shape, dtype=dtype, device=device)
    block = torch.empty(src.shape, dtype=dtype, pin_memory=True)
    src, dst, host = (t.unsqueeze(0) if t.dim() == 0 else t for t in (src, out, block))
    step = max(1, SLICE_BYTES * len(host) // max(1, host.nbytes))
    for i in range(0, len(host), step):
        host[i:i + step].copy_(src[i:i + step])
        dst[i:i + step].copy_(host[i:i + step], non_blocking=True)
    profiling.count("h2d_bytes", block.nbytes)
    profiling.count("h2d_pinned_bytes", block.nbytes)
    return out


def stage(a, device, cache=True, pack=None):
    """A host numpy array as a tensor on ``device`` in its wire format
    (uint16 counts widened to int32 there).  Cal-pack arrays are staged
    once per device (``cache``), with the cal pack whose lookup ``pack``
    is (:meth:`..utils.hostcache.PackCache.pack`) or loose.  A copy (not
    a cache hit) is the span ``host.stage``; a cached one counts
    ``pack_staged_bytes``.  An uncached copy to a CUDA device goes
    through page-locked memory and is not waited for; on the CPU the
    tensor shares the host array's buffer."""
    ck = (id(a), str(device))
    if cache:
        hit = _DEVICE_CACHE.get(ck, pack=pack)
        if hit is not None:
            return hit[0]
    with profiling.span("host.stage"):
        if not cache and torch.device(device).type == "cuda":
            t = _send_pinned(a, device)
        else:
            t = send(from_host(a), device)
        sent = t.nbytes
        if t.dtype == torch.int16:  # uint16 counts, widened on the device
            t = t.to(torch.int32) & 0xFFFF
    if cache:
        profiling.count("pack_staged_bytes", sent)
        _DEVICE_CACHE.put(ck, (t, a), t.nbytes, device, pack=pack)
    return t


def place(v, device):
    """A tensor or a host array (a lane, a row slab) as a contiguous
    tensor on ``device`` (the kernels read slabs through their plain row
    pitch); a host array is staged uncached, in its shape (0-d too)."""
    if isinstance(v, torch.Tensor):
        return v.contiguous().to(device)
    a = np.asarray(v)
    return stage(a, device, cache=False).reshape(a.shape)


def u16_to_host(t):
    """An int32 tensor of values in [0, 65535] as a uint16 numpy array,
    narrowed on the device (2 bytes a value cross)."""
    return t.to(torch.int16).cpu().numpy().view(np.uint16)


def _as_numpy(t, dq):
    a = t.numpy()
    return a.view(np.uint32) if dq else a


def to_numpy(t, dq=False):
    """The tensor ``t`` as host numpy; ``dq``: a DQ plane of int32 bit
    patterns, as uint32."""
    return _as_numpy(t.detach().cpu(), dq)


def _start_copy(t):
    """The host tensor that the counted copy of ``t`` fills: from a CUDA
    device a page-locked block, the copy issued on the current stream and
    not waited for; from the CPU ``t.cpu()``."""
    t = t.detach()
    profiling.count("d2h_bytes", t.nbytes)
    if t.device.type != "cuda":
        return t.cpu()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    profiling.count("d2h_pinned_bytes", t.nbytes)
    return host


def _fetch_all(items):
    """``[(tensor, dq)]`` as host numpy: every copy issued, then one sync
    of the current stream of each CUDA device among them."""
    hosts = [(_start_copy(t), dq) for t, dq in items]
    for dev in {t.device for t, _ in items if t.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()
    return [_as_numpy(h, dq) for h, dq in hosts]


def fetch(t, dq=False):
    """:func:`to_numpy`, counted as ``d2h_bytes`` (from a CUDA device
    through page-locked memory, ``d2h_pinned_bytes``)."""
    return _fetch_all([(t, dq)])[0]


@profiling.span("host.to_host")
def to_host(out):
    """The L1 -> L2 core's outputs as numpy (DQ planes as uint32),
    counted as :func:`fetch` counts, with one sync for all of them."""
    return dict(zip(out, _fetch_all([(v, k in _DQ_OUTPUTS) for k, v in out.items()])))
