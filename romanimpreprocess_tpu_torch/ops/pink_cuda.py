"""Hand-written CUDA kernels for the Cooley-Tukey pink-noise transform.

Replaces the TPU kernel ``ops/pink_pallas.py`` ``pink_frames_fused`` of
the JAX package.  The kernels (``csrc/pink.cu``) take the bfloat16
white spectrum as an INPUT, so a test can feed them the reference's
white noise.  The plain twin is :func:`.pink.pink_from_white_plain`; the
two share every cast point (bf16 spectrum, bf16 DFT matrices, f32
twiddle, bf16 intermediate, f32 sums) and differ by the order of the
sums.

Two paths, chosen by the factors of the length (:func:`uses_wgmma`):

* **wgmma** (``n1`` a multiple of 256 and ``n2`` of 128: every length
  from 2^16, the main path's 2^20 among them): each stage is one large
  product over all transforms on persistent CTAs, a producer thread
  filling a four-stage shared-memory ring by TMA and two consumer
  warpgroups issuing ``wgmma`` with float32 accumulators in registers;
  the spectrum goes from shared memory through registers, where it is
  shaped, into ``wgmma``'s A operand, so no shaped copy is written
  anywhere; the float32 twiddle is applied on the accumulator registers
  and the intermediate leaves as bfloat16.  A frame's sum is linear in that intermediate, so stage 1
  also writes each tile's share of it (``msum``), and stage 2 subtracts
  the mean from its accumulators before the frame is written, once: the
  shares are added in a fixed order, no atomics, and no pass reads the
  frames again.
* **mma.sync** (``n1 = 128``: lengths 2^14 and 2^15, which the wgmma
  tiles do not divide): the earlier three-pass kernels on ``wmma``
  fragments, the spectrum shaped on load, the mean removed by a pass
  over the finished frames.

Bound: operations.  One transform of length 2^20 is 12.9 GFLOP on the
bf16 tensor cores against 8.4 MB of traffic (:func:`flops`,
:func:`bytes_moved`).  What the wgmma kernels wait for is the arrival of
their ring stages from L2, not the tensor cores (``csrc/pink.cu``).
"""

import torch

from ..utils import hostcache
from . import cuda_build, pink

#: launches of the CUDA kernel (all its passes count as one) since the
#: last reset (set it to 0 to reset)
launches = 0

#: the kernels' tiles need n1 and n2 to be multiples of this
MIN_FACTOR = 128
#: the wgmma path's stage-2 tile is this many m1 columns wide
WGMMA_N1 = 256
#: stage 1 of the wgmma path takes its depth 32 Re and 32 Im rows at a time
K1_BLOCK = 32

# about 25 MB of device memory per entry at length 2^20
_CONST_CACHE = hostcache.BoundedCache(2, "pink_consts")


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


def uses_wgmma(n1, n2):
    """Whether a length that splits into n1 x n2 takes the wgmma path
    (its 128 x 128 and 64 x 256 tiles divide it) or the mma.sync one."""
    return n1 % WGMMA_N1 == 0 and n2 % MIN_FACTOR == 0


def block_k1(mat, n1):
    """Regroup the last axis of ``mat`` from [Re k1 (n1) | Im k1 (n1)] to
    blocks of :data:`K1_BLOCK` Re inputs followed by the same Im inputs."""
    lead = mat.shape[:-1]
    return (mat.reshape(*lead, 2, n1 // K1_BLOCK, K1_BLOCK).transpose(-3, -2)
            .reshape(*lead, 2 * n1).contiguous())


def kernel_constants(n1, n2, device):
    """The kernels' constant operands on ``device``, built once per
    (n1, n2, device): ``amp`` (n1, n2) bf16 and ``wc, ws`` (n2, n1) f32
    for both paths.  With the cos / sin matrices ``e1c, e1s`` (n1, n1)
    and ``e2c, e2s`` (n2, n2/2) of :func:`.pink.dft_matrices`:

    * wgmma path, both operands K-major (the contracted index runs along
      memory): ``b1t`` (2 n1, 2 n1) ``= [e1c^T | e1s^T ; -e1s^T | e1c^T]``,
      rows the Re then the Im outputs m1, its columns regrouped in
      blocks of :data:`K1_BLOCK` Re inputs k1 followed by the same Im
      inputs (:func:`block_k1`), the order in which stage 1 takes its
      depth so that one box of ``amp`` shapes both; ``a2`` (n2, 2 n2) ``= [e2c^T |
      e2s^T ; -e2s^T | e2c^T]``, rows the Re then the Im outputs m2;
      ``msum`` (2, n2) f32: ``e2c`` and ``e2s`` summed over m2 (in
      float64, rounded once), which turn sums of the intermediate into
      the frames' sums.
    * mma.sync path: ``b1r = [e1c; e1s]``, ``b1i = [-e1s; e1c]``
      (2 n1, n1); ``a2r = [e2c^T | e2s^T]``, ``a2i = [-e2s^T | e2c^T]``
      (n2/2, 2 n2).
    """
    ck = (n1, n2, str(device))
    hit = _CONST_CACHE.get(ck)
    if hit is not None:
        return hit
    e1c, e1s, e2c, e2s, wc, ws = pink.dft_matrices(n1, n2, n2 // 2, device)
    consts = dict(
        amp=pink.amplitude(n1 * n2, device).reshape(n1, n2).contiguous(),
        wc=wc.contiguous(), ws=ws.contiguous(),
    )
    a2r = torch.cat([e2c.T, e2s.T], dim=1)
    a2i = torch.cat([-e2s.T, e2c.T], dim=1)
    if uses_wgmma(n1, n2):
        consts["b1t"] = block_k1(torch.cat([torch.cat([e1c.T, e1s.T], dim=1),
                                            torch.cat([-e1s.T, e1c.T], dim=1)],
                                           dim=0), n1)
        consts["a2"] = torch.cat([a2r, a2i], dim=0).contiguous()
        consts["msum"] = torch.stack([e2c.double().sum(dim=1),
                                      e2s.double().sum(dim=1)]).float().contiguous()
    else:
        consts.update(
            b1r=torch.cat([e1c, e1s], dim=0).contiguous(),
            b1i=torch.cat([-e1s, e1c], dim=0).contiguous(),
            a2r=a2r.contiguous(), a2i=a2i.contiguous(),
        )
    return _CONST_CACHE.put(ck, consts)


def pink_from_white(white):
    """Shaped Cooley-Tukey transform of a white spectrum.

    ``white`` is (ntr, 2, length) bfloat16 (Re, Im), length a power of
    two.  Returns (2 * ntr, length / 2) float32: the Re frames, then the
    Im frames, each with its mean removed.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernels, which need both
    factors of the length to be multiples of 128 (length >= 2^14):
    the wgmma path from length 2^16, the mma.sync path below
    (:func:`uses_wgmma`).  A failed build or launch raises.
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
    wgmma = uses_wgmma(n1, n2)
    # partial sums of the frames: per stage-1 tile and warpgroup (wgmma),
    # per pass-2 tile (mma.sync)
    ntiles = 2 * (n1 // 128) * (n2 // 128) if wgmma else (n1 // 128) * (m2 // 64)
    scratch = torch.empty((ntr, 2 * n2, n1), dtype=torch.bfloat16, device=dev)
    partial = torch.empty((2 * ntr, ntiles), dtype=torch.float32, device=dev)
    out = torch.empty((2 * ntr, m2 * n1), dtype=torch.float32, device=dev)
    lib = cuda_build.library("pink.cu")
    with torch.cuda.device(dev):
        if wgmma:
            err = lib.pink_frames_wgmma_launch(
                white.data_ptr(), c["amp"].data_ptr(), c["b1t"].data_ptr(), c["wc"].data_ptr(), c["ws"].data_ptr(),
                c["msum"].data_ptr(), c["a2"].data_ptr(), scratch.data_ptr(),
                partial.data_ptr(),
                out.data_ptr(), ntr, n1, n2, cuda_build.stream_ptr(white),
            )
        else:
            err = lib.pink_frames_launch(
                white.data_ptr(), c["amp"].data_ptr(), c["b1r"].data_ptr(),
                c["b1i"].data_ptr(), c["wc"].data_ptr(), c["ws"].data_ptr(),
                c["a2r"].data_ptr(), c["a2i"].data_ptr(), scratch.data_ptr(),
                partial.data_ptr(), out.data_ptr(), ntr, n1, n2,
                cuda_build.stream_ptr(white),
            )
    cuda_build.check(err, "pink_frames_wgmma_launch" if wgmma else "pink_frames_launch")
    launches += 1
    return out
