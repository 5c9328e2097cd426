"""The host <-> device boundary: the port's copies between host numpy
and device tensors, their wire formats, byte counts and staging cache.

Wire formats, the same both ways: uint16 counts (L1 cubes, amp33)
cross the bus as int16, 2 bytes a value, and are int32 on the device,
widened (:func:`stage`) and narrowed (:func:`u16_to_host`) there; uint32
DQ planes are int32 bit patterns on the device; float32 crosses as it
is, other host dtypes as float32.  Copies to the device count
``h2d_bytes``, the counted copies back (:func:`fetch`, :func:`to_host`)
``d2h_bytes`` (:mod:`..utils.profiling`).

A counted copy back from a CUDA device lands in page-locked host memory
from torch's caching host allocator (``d2h_pinned_bytes``): every copy
of a call is issued without waiting, then one sync of the current stream
hands out numpy views of the blocks.  A block goes back to the allocator
only when the last array viewing it is freed (the array holds the
tensor that owns it), so a block is never handed out while an earlier
result still views it.  From the CPU, :func:`fetch` shares the tensor's
storage as ``.cpu()`` does.  A cal pack's arrays are staged once per
device through :data:`_DEVICE_CACHE` (``device_arrays``), which the
sim, the L1 -> L2 core and the noise engine share.  Nothing writes to a
staged tensor: on the CPU it shares the host array's buffer.
"""

import warnings

import numpy as np
import torch

from ..utils import hostcache, profiling

# device copies of cal-pack arrays, keyed by (id, device); the value
# holds the numpy array so a recycled id cannot alias a stale entry
_DEVICE_CACHE = hostcache.BoundedCache(64, "device_arrays")

#: the L1 -> L2 core's DQ outputs (int32 bit patterns, uint32 on the host)
_DQ_OUTPUTS = ("pdq", "rdq")


def from_host(a):
    """A host array as a CPU tensor in its wire format, sharing its
    buffer where the format allows (uint16 as int16 here)."""
    arr = np.asarray(a)
    with warnings.catch_warnings():
        # arrays read from ASDF are read-only; nothing writes to a staged
        # tensor, so the buffer is shared rather than copied
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        if arr.dtype in (np.uint32, np.uint16):
            return torch.from_numpy(np.ascontiguousarray(arr).view(
                np.int32 if arr.dtype == np.uint32 else np.int16))
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32))


def send(t, device):
    """The host tensor ``t`` copied to ``device``, counted as ``h2d_bytes``."""
    profiling.count("h2d_bytes", t.nbytes)
    return t.to(device)


def stage(a, device, cache=True):
    """A host numpy array as a tensor on ``device`` in its wire format
    (uint16 counts widened to int32 there).  Cal-pack arrays are staged
    once per device (``cache``).  A copy (not a cache hit) is the span
    ``host.stage``."""
    ck = (id(a), str(device))
    if cache:
        hit = _DEVICE_CACHE.get(ck)
        if hit is not None:
            return hit[0]
    with profiling.span("host.stage"):
        t = send(from_host(a), device)
        if t.dtype == torch.int16:  # uint16 counts, widened on the device
            t = t.to(torch.int32) & 0xFFFF
    if cache:
        _DEVICE_CACHE.put(ck, (t, a))
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
