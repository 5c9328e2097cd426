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

from ..utils import hostcache
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


#: device constants of the sky steps (grids, summation trees), built
#: once per shape and device: a copy from host memory would wait for the
#: device's queue on every call
_CONSTS = hostcache.BoundedCache(64, "sky_consts")


def _cached(key, make):
    hit = _CONSTS.get(key)
    return hit if hit is not None else _CONSTS.put(key, make())


def _const(v, device):
    """``v`` as a 0-d float32 tensor on ``device`` (a true divisor there:
    CUDA turns a division by a host scalar into a product with its
    reciprocal)."""
    return _cached(("const", float(v), str(device)), lambda: torch.tensor(
        float(v), dtype=torch.float32).to(device))


def tree_leaves(n, device):
    """The reference's summation tree over ``n`` values, as an index.

    XLA on the CPU reduces a dimension longer than 32 in windows of 32
    (zero-padded evenly at both ends, the odd zero at the end), each
    window summed in sequence from the init value 0, until 32 or fewer
    remain; those are summed in sequence.  Returns the long tensor of
    shape ``(32,) * L + (roots,)`` whose entry ``[k1, ..., kL, r]`` is
    the position among the ``n`` values of the ``k1``-th term of the
    ``k2``-th window ... of root ``r``, or ``n`` where the tree holds a
    padding zero: every level is then a sum down the first dimension
    (:func:`tree_sum_leaves`)."""
    def make():
        sizes, lo = [n], []
        while sizes[-1] > 32:
            pad = -sizes[-1] % 32
            lo.append(pad // 2)
            sizes.append((sizes[-1] + pad) // 32)
        pos = np.arange(sizes[-1])
        ok = np.ones(pos.shape, bool)
        for level in range(len(lo) - 1, -1, -1):  # a window's 32 terms
            pos = pos[None] * 32 + np.arange(32).reshape((32,) + (1,) * pos.ndim) - lo[level]
            ok = ok[None] & (pos >= 0) & (pos < sizes[level])
        return torch.from_numpy(np.where(ok, pos, n)).to(device)

    return _cached(("tree", n, str(device)), make)


def tree_sum_leaves(t, depth):
    """The sums of a tensor whose first ``depth`` dimensions are laid
    out as :func:`tree_leaves` (the trailing ones summed independently):
    level by level down the first dimension, each
    ``((0 + t_0) + t_1) + ...`` in float32.

    On the card one ``cumsum`` a level.  This rests on PyTorch's CUDA
    scan over a dimension that is not the last
    (``tensor_kernel_scan_outer_dim`` in ATen's ``cuda/ScanUtils.cuh``,
    checked with PyTorch 2.11): one thread runs down each column from 0,
    adding in float32, and a single column is scanned as a flat array
    instead, so it is padded to two.  A later PyTorch may scan
    otherwise: ``tests/test_torch_cuda.py`` holds this branch to the
    CPU's adds bit for bit.  On the CPU, where ``cumsum`` accumulates in
    float64, the adds one by one."""
    for _ in range(depth):
        if t.is_cuda:
            cols = t.reshape(t.shape[0], -1)
            if cols.shape[1] == 1:
                cols = torch.nn.functional.pad(cols, (0, 1))
            t = torch.cumsum(cols, dim=0)[-1, : t[0].numel()].reshape(t.shape[1:])
        else:
            s = t[0] + 0.0  # the init value first: -0 + 0 = +0
            for k in range(1, t.shape[0]):
                s = s + t[k]
            t = s
    return t


def nanquantile(flat, qs):
    """Linear-interpolation quantiles of the valid values of a 1-D
    tensor, in the reference's float32 steps (``jnp.nanquantile``):
    ``q (n - 1)``, its floor and ceiling as the ranks, and
    ``lo (1 - h) + hi h`` with ``h = q (n - 1) - floor``."""
    srt = torch.sort(flat).values  # NaN last
    cnt = (~torch.isnan(flat)).sum().to(torch.float32)
    qs = np.asarray(qs, np.float32)
    q = _cached(("qs", qs.tobytes(), str(flat.device)),
                lambda: torch.from_numpy(qs).to(flat.device)) * (cnt - 1)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1 - hw
    low = torch.clamp(torch.minimum(low, cnt - 1), min=0).long()
    high = torch.clamp(torch.minimum(high, cnt - 1), min=0).long()
    return srt[low] * lw + srt[high] * hw


def smooth_mode(arr, pc=25.0, pksmooth=0.5, niter=3, nbin=21):
    """Mode of the Gaussian-smoothed histogram (nan-aware).

    Same iteration as the reference (``sky.py:46-93``): percentile-based
    center/width initialization (:func:`nanquantile`), ``niter`` rounds
    of a 21-point kernel density scan with quadratic peak refinement.
    The histogram is summed in the reference's order: the values are
    laid out once as the leaves of its summation tree
    (:func:`tree_leaves`, padding as invalid values), so that each
    round's weights come out in that layout, bins last.  Returns 0-d
    tensors (mode, sigma * pksmooth).
    """
    flat = arr.reshape(-1)
    dev = flat.device
    pcs = np.asarray([pc, 50.0, 100.0 - pc], np.float32) / np.float32(100)
    c1, c2, c3 = nanquantile(flat, pcs)
    gauss_iqr = float(_norm.ppf((100.0 - pc) / 100.0) * 2)
    ctr = c2
    sigma = (c3 - c1) / _const(gauss_iqr, dev)

    offsets = linspace32(-1.0, 1.0, nbin, dev)
    leaves = tree_leaves(flat.numel(), dev)
    valid = torch.cat([~torch.isnan(flat), flat.new_zeros(1, dtype=torch.bool)])[leaves]
    vals = torch.cat([flat, flat.new_zeros(1)])[leaves]
    vals = torch.where(valid, vals, torch.zeros((), dtype=flat.dtype, device=dev))
    for _ in range(niter):
        z = ctr + offsets * sigma
        # weights for interior bins only (ends stay zero, as in reference)
        d = (z[1:-1] - vals[..., None]) / (pksmooth * sigma)
        w = torch.exp(-0.5 * d * d) * valid[..., None]
        hist = torch.zeros(nbin, dtype=flat.dtype, device=dev)
        hist[1:-1] = tree_sum_leaves(w, leaves.dim())
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


def linspace32(lo, hi, n, device):
    """``n`` points from ``lo`` to ``hi`` in float32, as the reference's
    ``jnp.linspace`` computes them: ``lo (1 - s) + hi s`` at
    ``s = i / (n - 1)``, the last point ``hi`` itself (built once per
    device)."""
    def make():
        s = torch.arange(n - 1, dtype=torch.float32) / (n - 1)
        end = torch.full((1,), hi, dtype=torch.float32)
        return torch.cat([lo * (1 - s) + hi * s, end]).to(device)

    return _cached(("linspace", lo, hi, n, str(device)), make)


def _medfit_grids(ny, nx, N, order, device):
    """(basis, LPX, LPY) of :func:`medfit` for an (ny, nx) map, built
    once per device: ``basis[k]`` the term ``P_i(u) P_j(v)`` on the
    N x N block centres, flattened, ``LPX`` / ``LPY`` the Legendre
    polynomials on the pixel grid."""
    def make():
        ky, kx, py, px = block_geometry(ny, nx, N)
        u_ = 2 * (px - 0.5 + kx * linspace32(0.5, N - 0.5, N, "cpu")) / nx - 1
        v_ = 2 * (py - 0.5 + ky * linspace32(0.5, N - 0.5, N, "cpu")) / ny - 1
        Pu = legendre_basis_1d(order, u_)  # (order+1, N)
        Pv = legendre_basis_1d(order, v_)
        # basis[k, jy, ix] = P_i(u[ix]) P_j(v[jy])
        basis = torch.stack([Pv[j][:, None] * Pu[i][None, :] for i, j in _tri_indices(order)])
        LPX = legendre_basis_1d(order, linspace32(-1.0, 1.0 - 2.0 / nx, nx, "cpu"))
        LPY = legendre_basis_1d(order, linspace32(-1.0, 1.0 - 2.0 / ny, ny, "cpu"))
        return tuple(a.to(device) for a in (basis.reshape(len(basis), N * N), LPX, LPY))

    return _cached(("medfit", ny, nx, N, order, str(device)), make)


def normal_solve(bflat, m):
    """Least-squares coefficients of the rows of ``bflat`` against
    ``m``: the normal equations ``(B B^T) c = B m``, solved.  The one
    step of the sky whose order of summation neither package sets (a
    BLAS product and a LAPACK solve)."""
    with full_fp32():
        return torch.linalg.solve(bflat @ bflat.T, bflat @ m)


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
    dev = arr.device
    basis, LPX, LPY = _medfit_grids(ny, nx, N, order, dev)
    meds = block_nanmedian_fused(arr, N) if backend == "cuda" else block_nanmedian(arr, N)
    good = ~torch.isnan(meds)
    m = torch.where(good, meds, torch.zeros_like(meds))
    coef = normal_solve(basis * good.reshape(-1)[None, :], m.reshape(-1))
    terms = _tri_indices(order)
    with full_fp32():
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
