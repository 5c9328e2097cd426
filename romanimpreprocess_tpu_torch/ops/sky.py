"""Sky estimation: binning, smoothed-histogram mode, 2-D Legendre fit.

Re-implements the reference's ``utils/sky.py`` (``binkxk:20``,
``smooth_mode:46``, ``medfit:96``).  ``medfit`` fits
``sum_ij c_ij P_i(u) P_j(v)`` (total degree <= order) to the N x N block
nanmedians and reconstructs the model on the full pixel grid via two
small matrix products, in full float32 (no TF32, see
:func:`full_fp32`).
"""

import contextlib

import numpy as np
import torch
from scipy.stats import norm as _norm

from .legendre import legendre_basis_1d


@contextlib.contextmanager
def full_fp32():
    """Run float32 matrix products in full float32 (TF32 off) and
    restore the caller's setting afterwards."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def binkxk(arr, k):
    """k x k mean binning of a 2-D tensor (remainder pixels dropped).

    The adds run in the reference's order (rows of a block first, then
    its columns), so the result matches it bit for bit.  NaN poisons its
    block, as with a mean.
    """
    ny, nx = arr.shape
    nyo, nxo = ny // k, nx // k
    a = arr[: k * nyo, : k * nxo]
    r = a[0::k]
    for i in range(1, k):
        r = r + a[i::k]
    c = r[:, 0::k]
    for j in range(1, k):
        c = c + r[:, j::k]
    return c / (k * k)


def smooth_mode(arr, pc=25.0, pksmooth=0.5, niter=3, nbin=21):
    """Mode of the Gaussian-smoothed histogram (nan-aware).

    Same iteration as the reference (``sky.py:46-93``): percentile-based
    center/width initialization (``torch.nanquantile``'s linear
    interpolation is numpy's), ``niter`` rounds of a 21-point kernel
    density scan with quadratic peak refinement.  Returns 0-d tensors
    (mode, sigma * pksmooth).
    """
    flat = arr.reshape(-1)
    q = torch.tensor([pc / 100.0, 0.5, 1.0 - pc / 100.0],
                     dtype=flat.dtype, device=flat.device)
    c1, c2, c3 = torch.nanquantile(flat, q)
    gauss_iqr = float(_norm.ppf((100.0 - pc) / 100.0) * 2)
    ctr = c2
    sigma = (c3 - c1) / gauss_iqr

    offsets = torch.linspace(-1.0, 1.0, nbin, dtype=flat.dtype,
                             device=flat.device)
    valid = ~torch.isnan(flat)
    vals = torch.where(valid, flat, torch.zeros((), dtype=flat.dtype,
                                                device=flat.device))
    for _ in range(niter):
        z = ctr + offsets * sigma
        # weights for interior bins only (ends stay zero, as in reference)
        d = (z[1:-1, None] - vals[None, :]) / (pksmooth * sigma)
        w = torch.exp(-0.5 * d * d) * valid[None, :]
        hist = torch.zeros(nbin, dtype=flat.dtype, device=flat.device)
        hist[1:-1] = w.sum(dim=1)
        i_pk = torch.argmax(hist)
        up = hist[torch.clamp(i_pk + 1, max=nbin - 1)]
        dn = hist[(i_pk - 1) % nbin]
        b = (up - dn) / 2.0
        a = (up + dn) / 2.0 - hist[i_pk]
        ctr = z[i_pk] + (z[1] - z[0]) * (-b / (2.0 * a))
    return ctr, sigma * pksmooth


def block_geometry(ny, nx, N):
    """(ky, kx, py, px): block size and the centring offsets of the
    N x N block grid (remainder rows/columns split evenly)."""
    return ny // N, nx // N, (ny % N) // 2, (nx % N) // 2


def block_nanmedian(arr, N):
    """Exact nanmedian of N x N blocks (plain PyTorch).

    Sorts each block (NaNs sort last) and averages its two middle valid
    values, ``0.5 * (lo + hi)``, as numpy does; a block with no valid
    value gives NaN.  Bit-identical to ``np.nanmedian``; the plain twin
    of the CUDA kernel in :mod:`.median_cuda`.
    """
    ny, nx = arr.shape
    ky, kx, py, px = block_geometry(ny, nx, N)
    blocks = (arr[py : py + N * ky, px : px + N * kx]
              .reshape(N, ky, N, kx).permute(0, 2, 1, 3)
              .reshape(N * N, ky * kx))
    srt = torch.sort(blocks, dim=1).values
    cnt = (~torch.isnan(blocks)).sum(dim=1)
    k_lo = torch.clamp((cnt - 1) // 2, min=0)
    k_hi = cnt // 2
    lo = torch.gather(srt, 1, k_lo[:, None])[:, 0]
    hi = torch.gather(srt, 1, k_hi[:, None])[:, 0]
    med = 0.5 * (lo + hi)
    nan = torch.full_like(med, float("nan"))
    return torch.where(cnt > 0, med, nan).reshape(N, N)


def _tri_indices(order):
    """(i, j) exponent pairs in the reference's coefficient ordering
    (``sky.py:127-134``): i ascending, j in 0..order-i."""
    return [(i, j) for i in range(order + 1) for j in range(order + 1 - i)]


def _linspace32(lo, hi, n, device):
    return torch.linspace(lo, hi, n, dtype=torch.float32, device=device)


def medfit(arr, N=8, order=2, backend="xla"):
    """Low-order 2-D Legendre fit to block nanmedians.

    Returns (coef, model) where ``model[y, x] = sum coef_k P_i(u) P_j(v)``
    with u, v the x/y coordinates scaled to [-1, 1) and the (i, j)
    ordering of the reference (``sky.py:96-191``).  ``backend='cuda'``
    takes the block medians from the CUDA kernel
    (:func:`.median_cuda.block_nanmedian_fused`, bit-identical).
    """
    from .median_cuda import block_nanmedian_fused

    ny, nx = arr.shape
    ky, kx, py, px = block_geometry(ny, nx, N)
    dev = arr.device
    u_ = 2 * (px - 0.5 + kx * _linspace32(0.5, N - 0.5, N, dev)) / nx - 1
    v_ = 2 * (py - 0.5 + ky * _linspace32(0.5, N - 0.5, N, dev)) / ny - 1

    meds = block_nanmedian_fused(arr, N) if backend == "cuda" else block_nanmedian(arr, N)

    terms = _tri_indices(order)
    nc = len(terms)
    Pu = legendre_basis_1d(order, u_)  # (order+1, N)
    Pv = legendre_basis_1d(order, v_)
    # basis[k, jy, ix] = P_i(u[ix]) P_j(v[jy])
    basis = torch.stack([Pv[j][:, None] * Pu[i][None, :] for i, j in terms])

    good = ~torch.isnan(meds)
    m = torch.where(good, meds, torch.zeros_like(meds))
    bflat = basis.reshape(nc, N * N) * good.reshape(-1)[None, :]
    uu = _linspace32(-1.0, 1.0 - 2.0 / nx, nx, dev)
    vv = _linspace32(-1.0, 1.0 - 2.0 / ny, ny, dev)
    LPX = legendre_basis_1d(order, uu)  # (order+1, nx)
    LPY = legendre_basis_1d(order, vv)  # (order+1, ny)
    with full_fp32():
        A = bflat @ bflat.T
        b = bflat @ m.reshape(-1)
        coef = torch.linalg.solve(A, b)
        cm = torch.zeros((order + 1, order + 1), dtype=torch.float32,
                         device=dev)
        for k, (i, j) in enumerate(terms):
            cm[j, i] = coef[k]
        # model = sum_k coef_k outer(LPY[j_k], LPX[i_k]) as one
        # rank-(order+1) product chain (ny, K) @ (K, K) @ (K, nx)
        model = (LPY.T @ cm) @ LPX
    return coef, model.to(arr.dtype)


def sky_model_from_coefs(coefs, ny, nx, order):
    """Reconstruct the medfit sky model (float64 numpy) from stored
    coefficients."""
    terms = _tri_indices(order)
    uu = torch.from_numpy(np.linspace(-1.0, 1.0 - 2.0 / nx, nx))
    vv = torch.from_numpy(np.linspace(-1.0, 1.0 - 2.0 / ny, ny))
    LPX = legendre_basis_1d(order, uu).numpy()
    LPY = legendre_basis_1d(order, vv).numpy()
    model = np.zeros((ny, nx))
    for k, (i, j) in enumerate(terms):
        model += float(coefs[k]) * np.outer(LPY[j], LPX[i])
    return model


def bisect_quantiles(x, qs, iters=27):
    """Quantiles by counting bisection (reference
    ``ops/sky.py:210-235`` of the JAX package), float32.

    Each of ``iters`` rounds counts the elements at or below the
    midpoint of every quantile's bracket, in one pass for all of
    ``qs``, and keeps the half that holds the target rank ``q * n``.
    The result lies within (max - min) * 2^-iters of the bracket's
    limit: below the float32 resolution of the data range, which is
    what the noise engine's z-clip needs.  Returns a (len(qs),) tensor.
    """
    flat = x.reshape(-1)
    n = flat.shape[0]
    targets = torch.tensor([float(q) * n for q in qs], dtype=torch.float32,
                           device=x.device)
    lo = flat.min().expand(len(qs))
    hi = flat.max().expand(len(qs))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = (flat[None, :] <= mid[:, None]).sum(dim=1).to(torch.float32)
        too_low = cnt < targets
        lo = torch.where(too_low, mid, lo)
        hi = torch.where(too_low, hi, mid)
    return 0.5 * (lo + hi)
