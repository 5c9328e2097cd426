"""Hand-written CUDA kernel for the read-axis contraction.

Replaces the TPU kernel ``ops/contract_pallas.py`` ``contract_reads`` of
the JAX package: ``out[j] = sum_r T[j, r] * x[r]``, the
cumulative-membership contraction that turns per-read Poisson increments
into MultiAccum resultants.  The kernel (``csrc/contract.cu``) is one
streaming pass: every thread reads its pixels' ``nreads`` values once
and writes ``ngrp`` sums.  Its plain twin is
:func:`contract_reads_plain`, the same sums as an ordered loop of
elementwise products and adds, with which it agrees bit for bit.

Bound: bytes, 1.34 GB at 14 reads -> 6 groups of 4088^2
(:func:`bytes_moved`).
"""

import torch

from . import cuda_build

#: launches of the CUDA kernel since the last reset (set it to 0 to reset)
launches = 0

MAX_GROUPS = 32
MAX_T_BYTES = 48 * 1024


def bytes_moved(ngrp, nreads, ny, nx):
    """Least bytes the function must move: x read once, out written
    once (T is a few hundred bytes)."""
    return 4 * ny * nx * (nreads + ngrp) + 4 * ngrp * nreads


def contract_reads_plain(T, x):
    """Plain PyTorch version of the kernel: for each group, the
    products ``T[j, r] * x[r]`` added in read order r = 0, 1, ...
    (each product and each add rounded to float32)."""
    tw = T.detach().to("cpu", torch.float32).tolist()
    out = []
    for row in tw:
        acc = x[0] * row[0]
        for r in range(1, len(row)):
            acc = acc + x[r] * row[r]
        out.append(acc)
    return torch.stack(out)


def contract_reads(T, x):
    """``einsum('jr,ryx->jyx', T, x)`` summed in read order.

    ``T`` is (ngrp, nreads) float32, ``x`` (nreads, ny, nx) float32;
    returns (ngrp, ny, nx) float32.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel.
    """
    if x.device.type == "cpu":
        return contract_reads_plain(T, x)
    global launches
    ngrp, nreads = T.shape
    _, ny, nx = x.shape
    if not 1 <= ngrp <= MAX_GROUPS or 4 * ngrp * nreads > MAX_T_BYTES:
        raise ValueError(
            f"contraction kernel takes 1..{MAX_GROUPS} groups and a T of at "
            f"most {MAX_T_BYTES} bytes, got T {tuple(T.shape)}")
    req = cuda_build.require
    req(T, "T", torch.float32, (ngrp, nreads))
    req(x, "x", torch.float32, (nreads, ny, nx))
    if T.device != x.device:
        raise ValueError(f"T is on {T.device}, x on {x.device}")
    out = torch.empty((ngrp, ny, nx), dtype=torch.float32, device=x.device)
    npix = ny * nx
    vec4 = int(npix % 4 == 0 and x.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    lib = cuda_build.library("contract.cu")
    with torch.cuda.device(x.device):
        err = lib.contract_reads_launch(
            T.data_ptr(), x.data_ptr(), out.data_ptr(), ngrp, nreads, npix,
            vec4, cuda_build.stream_ptr(x),
        )
    cuda_build.check(err, "contract_reads_launch")
    launches += 1
    return out
