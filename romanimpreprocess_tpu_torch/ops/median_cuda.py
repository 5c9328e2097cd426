"""Hand-written CUDA kernels for exact block nanmedians.

Replaces the TPU kernel ``ops/median_pallas.py`` ``block_nanmedian_fused``
of the JAX package.  Its plain twin is :func:`.sky.block_nanmedian`, with
which it agrees bit for bit (both equal ``np.nanmedian``).

Two kernels in ``csrc/blockmed.cu``, chosen by the block's size
(:func:`plan`):

* **cluster**: a thread-block cluster of 1, 2, 4 or 8 CTAs per block
  reads the block from device memory once, keeps it in shared memory as
  uint32 total-order keys, and selects the lower middle value by eight
  rounds of 4-bit digits (integer counts summed across the cluster
  through distributed shared memory, each thread compacting the keys
  that still match); the upper middle value is the same key or the next
  one in order.  Serves every block of up to
  ``MAX_CLUSTER * KEYS_MAX`` values; the main path's 511 x 511 blocks
  take 8 CTAs each, 512 CTAs in all.
* **stream**: one CTA per block and 32 rounds of bit bisection that read
  the block again each round, for blocks that do not fit a cluster
  (``N = 1`` on a full frame).  Slow; no main path takes it.

Bound: bytes, one read of the blocks (66.8 MB at 4088^2,
:func:`bytes_moved`).  The cluster kernel does read once; what it waits
for is the selection itself: four waves of 16 clusters, each with its
scans of the on-chip keys and nine cluster barriers.
"""

import torch

from . import cuda_build
from .sky import block_geometry, block_nanmedian

#: launches of the CUDA kernel since the last reset (set it to 0 to reset)
launches = 0

MAX_N = 128
#: CTAs of the largest (portable) thread-block cluster
MAX_CLUSTER = 8
#: keys per CTA beyond which a block gets a larger cluster (128 KB)
KEYS_TARGET = 32768
#: keys per CTA that fit in its shared memory (200 KB of 227 KB)
KEYS_MAX = 51200


def bytes_moved(ny, nx, N):
    """Least bytes the function must move: every block pixel read once,
    the N x N medians written once."""
    ky, kx, _, _ = block_geometry(ny, nx, N)
    return 4 * (N * ky * N * kx + N * N)


def plan(ny, nx, N):
    """Which kernel serves (ny, nx) / N: ``("cluster", ctas, rows_per)``
    with ``ctas`` CTAs per block holding ``rows_per`` rows of the block
    each, or ``("stream", 0, 0)``.  The cluster grows (1, 2, 4, 8) until
    a CTA's share is at most :data:`KEYS_TARGET` keys; a share above
    :data:`KEYS_MAX` at 8 CTAs does not fit and streams."""
    ky, kx, _, _ = block_geometry(ny, nx, N)
    ctas = 1
    while ctas < MAX_CLUSTER and -(-ky // ctas) * kx > KEYS_TARGET:
        ctas *= 2
    rows_per = -(-ky // ctas)
    if rows_per * kx > KEYS_MAX:
        return ("stream", 0, 0)
    return ("cluster", ctas, rows_per)


def block_nanmedian_fused(arr, N):
    """Exact nanmedian of the N x N blocks of a 2-D float32 tensor.

    The blocks are those of :func:`.sky.block_nanmedian` (remainder rows
    and columns split evenly around them).  ``arr`` may be a row-strided
    view (unit column stride), such as the active region of a frame.  A
    CPU tensor takes the plain version; a CUDA tensor launches the
    cluster kernel or, for a block too large for a cluster's shared
    memory, the streaming kernel (:func:`plan`).  A launch the card
    refuses raises.
    """
    if N > MAX_N:
        raise ValueError(f"block_nanmedian_fused supports N <= {MAX_N}, got {N}")
    if arr.device.type == "cpu":
        return block_nanmedian(arr, N)
    global launches
    if arr.device.type != "cuda":
        raise ValueError(f"arr: expected a CUDA tensor, got {arr.device}")
    if arr.dtype != torch.float32 or arr.dim() != 2:
        raise ValueError(f"arr: expected a 2-D float32 tensor, got "
                         f"{arr.dtype} {tuple(arr.shape)}")
    # (the row stride of a single row is never used)
    if arr.stride(1) != 1 or (arr.shape[0] > 1 and arr.stride(0) < arr.shape[1]):
        raise ValueError("arr: rows must be contiguous (unit column stride)")
    ny, nx = arr.shape
    if ny < N or nx < N:
        raise ValueError(f"arr {tuple(arr.shape)} is smaller than {N} blocks")
    _, ctas, rows_per = plan(ny, nx, N)
    out = torch.empty((N, N), dtype=torch.float32, device=arr.device)
    lib = cuda_build.library("blockmed.cu")
    with torch.cuda.device(arr.device):
        err = lib.block_nanmedian_launch(
            arr.data_ptr(), out.data_ptr(), ny, nx, arr.stride(0), N,
            ctas, rows_per, cuda_build.stream_ptr(arr),
        )
    cuda_build.check(err, "block_nanmedian_launch")
    launches += 1
    return out
