"""Hand-written CUDA kernel for exact block nanmedians.

Replaces the TPU kernel ``ops/median_pallas.py`` ``block_nanmedian_fused``
of the JAX package.  The kernel (``csrc/blockmed.cu``) gives each of the
N x N blocks one CTA, which finds the two middle order statistics by 32
rounds of bisection over the float total-order key and averages them;
its plain twin is :func:`.sky.block_nanmedian`, with which it agrees bit
for bit (both equal ``np.nanmedian``).

Bound: bytes, one read of the blocks (66.8 MB at 4088^2,
:func:`bytes_moved`).
"""

import torch

from . import cuda_build
from .sky import block_geometry, block_nanmedian

#: launches of the CUDA kernel since the last reset (set it to 0 to reset)
launches = 0

MAX_N = 128


def bytes_moved(ny, nx, N):
    """Least bytes the function must move: every block pixel read once,
    the N x N medians written once."""
    ky, kx, _, _ = block_geometry(ny, nx, N)
    return 4 * (N * ky * N * kx + N * N)


def block_nanmedian_fused(arr, N):
    """Exact nanmedian of the N x N blocks of a 2-D float32 tensor.

    The blocks are those of :func:`.sky.block_nanmedian` (remainder rows
    and columns split evenly around them).  ``arr`` may be a row-strided
    view (unit column stride), such as the active region of a frame.  A
    CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
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
    if arr.stride(1) != 1 or arr.stride(0) < arr.shape[1]:
        raise ValueError("arr: rows must be contiguous (unit column stride)")
    ny, nx = arr.shape
    if ny < N or nx < N:
        raise ValueError(f"arr {tuple(arr.shape)} is smaller than {N} blocks")
    out = torch.empty((N, N), dtype=torch.float32, device=arr.device)
    lib = cuda_build.library("blockmed.cu")
    with torch.cuda.device(arr.device):
        err = lib.block_nanmedian_launch(
            arr.data_ptr(), out.data_ptr(), ny, nx, arr.stride(0), N,
            cuda_build.stream_ptr(arr),
        )
    cuda_build.check(err, "block_nanmedian_launch")
    launches += 1
    return out
