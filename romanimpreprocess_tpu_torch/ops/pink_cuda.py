"""Hand-written CUDA kernel for the Cooley-Tukey pink-noise transform.

Replaces the TPU kernel ``ops/pink_pallas.py`` ``pink_frames_fused`` of
the JAX package.  The kernel (``csrc/pink.cu``) takes the bfloat16
white spectrum as an INPUT, so a test can feed it the reference's white
noise.  It runs three passes: a tensor-core product over (k2, m1) that
shapes the spectrum on load and applies the float32 twiddle to its
accumulators, writing bfloat16 to a scratch tensor; a tensor-core
product over (m2, m1) that writes the float32 frames in time order with
one partial sum per tile; and a pass that subtracts each frame's mean,
the partial sums added in a fixed order (no atomics).  Its plain twin is
:func:`.pink.pink_from_white_plain`; the two share every cast point
(bf16 spectrum, bf16 DFT matrices, f32 twiddle, bf16 intermediate, f32
sums) and differ by the order of the sums.

Bound: operations.  One transform of length 2^20 is 12.9 GFLOP on the
bf16 tensor cores against 8.4 MB of traffic (:func:`flops`,
:func:`bytes_moved`).
"""

import torch

from ..utils import hostcache
from . import cuda_build, pink

#: launches of the CUDA kernel (its three passes count as one) since the
#: last reset (set it to 0 to reset)
launches = 0

#: the kernel's tiles need n1 and n2 to be multiples of this
MIN_FACTOR = 128

# about 25 MB of device memory per entry at length 2^20
_CONST_CACHE = hostcache.BoundedCache(2)


def flops(ntr, length):
    """Operations of ``ntr`` transforms: both stages compute Re and Im,
    each a product with depth 2 n1 (stage 1, n2 x n1 outputs) or 2 n2
    (stage 2, n2/2 x n1 outputs)."""
    n1, n2 = pink.split_length(length)
    return ntr * (2 * 2 * n2 * n1 * 2 * n1 + 2 * 2 * (n2 // 2) * n1 * 2 * n2)


def bytes_moved(ntr, length):
    """Least bytes the function must move: the bf16 white spectrum read
    once, the f32 frames written once (the constants are a few MB)."""
    return ntr * (2 * length * 2 + 2 * (length // 2) * 4)


def kernel_constants(n1, n2, device):
    """The kernel's constant operands on ``device``, built once per
    (n1, n2, device): ``amp`` (n1, n2) bf16; ``b1r = [e1c; e1s]`` and
    ``b1i = [-e1s; e1c]`` (2 n1, n1) bf16; ``wc, ws`` (n2, n1) f32;
    ``a2r = [e2c^T | e2s^T]`` and ``a2i = [-e2s^T | e2c^T]``
    (n2/2, 2 n2) bf16."""
    ck = (n1, n2, str(device))
    hit = _CONST_CACHE.get(ck)
    if hit is not None:
        return hit
    e1c, e1s, e2c, e2s, wc, ws = pink.dft_matrices(n1, n2, n2 // 2, device)
    consts = dict(
        amp=pink.amplitude(n1 * n2, device).reshape(n1, n2).contiguous(),
        b1r=torch.cat([e1c, e1s], dim=0).contiguous(),
        b1i=torch.cat([-e1s, e1c], dim=0).contiguous(),
        wc=wc.contiguous(), ws=ws.contiguous(),
        a2r=torch.cat([e2c.T, e2s.T], dim=1).contiguous(),
        a2i=torch.cat([-e2s.T, e2c.T], dim=1).contiguous(),
    )
    return _CONST_CACHE.put(ck, consts)


def pink_from_white(white):
    """Shaped Cooley-Tukey transform of a white spectrum.

    ``white`` is (ntr, 2, length) bfloat16 (Re, Im), length a power of
    two.  Returns (2 * ntr, length / 2) float32: the Re frames, then the
    Im frames, each with its mean removed.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel, which needs both
    factors of the length to be multiples of 128 (length >= 2^14).
    """
    if white.device.type == "cpu":
        return pink.pink_from_white_plain(white)
    global launches
    ntr, _, length = white.shape
    if length <= 0 or length & (length - 1):
        raise ValueError(f"length {length} is not a power of two")
    n1, n2 = pink.split_length(length)
    if n1 % MIN_FACTOR or n2 % MIN_FACTOR:
        raise ValueError(
            f"pink kernel needs both factors of the length to be multiples "
            f"of {MIN_FACTOR}; length {length} splits into {n1} x {n2}")
    if not 1 <= ntr <= 32767:
        raise ValueError(f"pink kernel takes 1..32767 transforms, got {ntr}")
    cuda_build.require(white, "white", torch.bfloat16, (ntr, 2, length))
    dev = white.device
    c = kernel_constants(n1, n2, dev)
    m2 = n2 // 2
    ntiles = (n1 // 128) * (m2 // 64)
    scratch = torch.empty((ntr, 2 * n2, n1), dtype=torch.bfloat16, device=dev)
    partial = torch.empty((2 * ntr, ntiles), dtype=torch.float32, device=dev)
    out = torch.empty((2 * ntr, m2 * n1), dtype=torch.float32, device=dev)
    lib = cuda_build.library("pink.cu")
    with torch.cuda.device(dev):
        err = lib.pink_frames_launch(
            white.data_ptr(), c["amp"].data_ptr(), c["b1r"].data_ptr(),
            c["b1i"].data_ptr(), c["wc"].data_ptr(), c["ws"].data_ptr(),
            c["a2r"].data_ptr(), c["a2i"].data_ptr(), scratch.data_ptr(),
            partial.data_ptr(), out.data_ptr(), ntr, n1, n2,
            cuda_build.stream_ptr(white),
        )
    cuda_build.check(err, "pink_frames_launch")
    launches += 1
    return out
