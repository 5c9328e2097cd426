"""Detector characterization from flat/dark ramps (solid-waffle analog).

The reference delegates linearity/gain/IPC *measurement* to the
external solid-waffle package and only consumes its output files
(SURVEY.md §2.3).  This module internalizes the core characterization:

- :func:`fit_linearity` — per-pixel Legendre linearity curves from
  flat-field ramps: a shared monotone response map g(S) (Legendre in the
  rescaled signal) and per-ramp flux rates, the rates eliminated
  analytically and the response found by batched inverse iteration
  (``torch.linalg.solve`` on one 7 x 7 system per pixel), over row slabs
  of the frame on a torch device.  Output follows the
  ``linearitylegendre`` reference-file convention (Slin = 0 and
  dSlin/dS = 1 at Sref).
- :func:`gain_from_mean_variance` — photon-transfer gain per superpixel
  from flat/dark difference frames: g = mean(signal) / var(diff/sqrt2).
- :func:`ipc_from_autocorr` — IPC alphas from nearest-neighbor
  autocorrelations of flat difference frames (correlation method:
  alpha ~ C(d)/ (2 C(0)) for shot-noise-dominated diffs; numpy).
"""

import numpy as np
import torch

from ..config import resolve_device
from ..ops.legendre import legendre_basis_1d
from ..ops.sky import full_fp32

#: pixels per row slab of :func:`fit_linearity`: with 35 samples and
#: ``p_order=6`` a slab's Legendre stack is about 1 GB and its working
#: set a few GB, whatever the frame size
LINFIT_SLAB_PIXELS = 1 << 20


def _linfit_core(stacked, smin, smax, sref, tw, t2sum, *, p_order, n_iter):
    """The linearity fit of a set of pixels, on their device.

    ``stacked``: (nsamp, npix) raw DN of every ramp's frames;
    ``smin``, ``smax``, ``sref``: (npix,); ``tw``: (nramp, nsamp)
    per-ramp frame times (zero outside the ramp); ``t2sum``: (nramp,)
    sum of squared times per ramp.  Returns (coef_out (nc, npix),
    dg_ds (npix,)).
    """
    nc = p_order + 1
    z = -1.0 + 2.0 * (stacked - smin) / (smax - smin)
    z = torch.clamp(z, -1.0, 1.0)
    # (npix, nc, nsamp): row i of pixel p is P_i at its samples
    P = legendre_basis_1d(p_order, z.T).permute(1, 0, 2)

    # Eliminating the per-ramp rates analytically, the response
    # coefficients minimize c^T M c with
    #   M = sum_k b_k b_k^T - sum_r (w_r w_r^T) / sum_{k in r} t_k^2,
    #   b_k = P(z_k),  w_r = sum_{k in r} t_k b_k
    # (the quadratic form of residuals after projecting out each
    # ramp's best linear-in-time fit).  The response is M's
    # near-null eigenvector; batched inverse iteration finds it.
    with full_fp32():
        M = P @ P.transpose(1, 2)  # (npix, nc, nc)
        for r in range(tw.shape[0]):
            w = P @ tw[r]  # (npix, nc)
            M = M - w[:, :, None] * w[:, None, :] / t2sum[r]
    del P
    eps = 1e-5 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / nc
    M = M + eps[:, None, None] * torch.eye(nc, dtype=M.dtype, device=M.device)
    # start from the z-linear response (coef = e_1)
    x = torch.zeros(M.shape[:-1], dtype=M.dtype, device=M.device)
    x[:, 1] = 1.0
    for _ in range(n_iter):
        x = torch.linalg.solve(M, x[..., None])[..., 0]
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    coef = x.T  # (nc, npix)

    # gauge fix at Sref: value 0, derivative 1
    zref = -1.0 + 2.0 * (sref - smin) / (smax - smin)
    g_ref = (coef * legendre_basis_1d(p_order, zref)).sum(0)
    # derivative dP_L/dz via finite difference of the basis (exact
    # would use the derivative recursion; h small vs the domain)
    h = 1e-3
    Pref_p = legendre_basis_1d(p_order, zref + h)
    Pref_m = legendre_basis_1d(p_order, zref - h)
    dg_dz = (coef * ((Pref_p - Pref_m) / (2 * h))).sum(0)
    dz_ds = 2.0 / (smax - smin)
    dg_ds = dg_dz * dz_ds
    dg_ds = torch.where(torch.abs(dg_ds) < 1e-8, 1e-8, dg_ds)

    coef_out = coef / dg_ds
    coef_out[0] -= g_ref / dg_ds
    return coef_out, dg_ds


def _as_device(a, dev):
    """A host array or a tensor as a float32 tensor on ``dev``."""
    if torch.is_tensor(a):
        return a.to(device=dev, dtype=torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def fit_linearity(ramps, t_arrays, sref_frame_value, *, p_order=6,
                  smin=None, smax=None, n_iter=4, sat_fraction=0.93,
                  device=None):
    """Fit per-pixel Legendre linearity curves from ramp cubes.

    Parameters
    ----------
    ramps : list of (nframes_r, ny, nx) float32 (numpy or tensors)
        Raw-DN ramp cubes (e.g. high flat, low flat); each assumed to
        accrue charge linearly in time at an unknown per-pixel rate.
    t_arrays : list of (nframes_r,) float
        Frame times of each ramp (same clock).
    sref_frame_value : (ny, nx) float32
        Raw DN defining the linearized zero (the bias frame — the
        reference's BIAS SLICE).
    p_order : Legendre order of the fitted response.
    smin, smax : optional (ny, nx) domain bounds; default: data range
        padded (the reference's NEGATIVEPAD below bias) and the
        ``sat_fraction`` quantile of the brightest ramp.
    n_iter : inverse-iteration steps.
    device : where the fit runs (default ``cuda``); the ramps are
        staged there whole, the fit runs over row slabs of about
        :data:`LINFIT_SLAB_PIXELS` pixels.

    Returns
    -------
    dict of host arrays: ``data`` (p_order+1, ny, nx), ``Smin``,
    ``Smax``, ``Sref``, ``dq`` — the ``linearitylegendre`` tree payload.

    Model: a shared monotone map g(S) (per pixel) with g(S_k) ~ a_r t_k
    for each ramp r.  Gauge fixing: g -> (g - g(Sref)) / g'(Sref) makes
    Slin = 0 and slope 1 at Sref, matching the reference convention
    (``docs/from_sim_README.rst`` linearity spec).  The inverse iteration
    fixes the response only up to sign, which ``coef / dg_ds`` cancels;
    ``dq`` (``dg_ds <= 1e-6``) is set where the fitted response does not
    rise at Sref.
    """
    dev = resolve_device(device)
    ramp_len = [int(r.shape[0]) for r in ramps]
    stacked = torch.cat([_as_device(r, dev) for r in ramps])
    ramp_id = np.concatenate(
        [np.full(n, i, np.int32) for i, n in enumerate(ramp_len)]
    )
    tvec = np.concatenate([np.asarray(t, np.float64) for t in t_arrays])
    nramp = len(ramps)
    tw = np.stack(
        [np.where(ramp_id == r, tvec, 0.0) for r in range(nramp)]
    ).astype(np.float32)
    t2sum = np.array(
        [np.sum(tvec[ramp_id == r] ** 2) for r in range(nramp)],
        np.float32,
    )
    tw, t2sum = torch.from_numpy(tw).to(dev), torch.from_numpy(t2sum).to(dev)

    sref = _as_device(sref_frame_value, dev)
    smin = (torch.minimum(stacked.amin(0), sref) - 500.0  # NEGATIVEPAD
            if smin is None else _as_device(smin, dev))
    if smax is None:
        # a 0-d tensor on the device, not a Python scalar: CUDA divides
        # by a host scalar as a product with its reciprocal, which
        # rounds otherwise than numpy's float32 division
        frac = torch.tensor(sat_fraction, dtype=torch.float32, device=dev)
        smax = stacked.amax(0) / frac
    else:
        smax = _as_device(smax, dev)

    nsamp, ny, nx = stacked.shape
    nc = p_order + 1
    coef_out = torch.empty((nc, ny, nx), dtype=torch.float32, device=dev)
    dg_ds = torch.empty((ny, nx), dtype=torch.float32, device=dev)
    rows = max(1, LINFIT_SLAB_PIXELS // nx)
    for y0 in range(0, ny, rows):
        sl = slice(y0, y0 + rows)
        c, g = _linfit_core(
            stacked[:, sl].reshape(nsamp, -1), smin[sl].reshape(-1),
            smax[sl].reshape(-1), sref[sl].reshape(-1), tw, t2sum,
            p_order=p_order, n_iter=n_iter)
        coef_out[:, sl] = c.reshape(nc, -1, nx)
        dg_ds[sl] = g.reshape(-1, nx)
    del stacked

    dq = (dg_ds <= 1e-6).to(torch.int32)
    return {
        "data": coef_out.cpu().numpy(),
        "Smin": smin.cpu().numpy(),
        "Smax": smax.cpu().numpy(),
        "Sref": sref.cpu().numpy(),
        "dq": dq.cpu().numpy().astype(np.uint32),
    }


def make_linearity_file(out_path, sca, ramps, t_arrays, sref_frame_value,
                        *, p_order=6, pflat=None, dark_slope=None, device=None,
                        **kw):
    """Fit and write a ``linearitylegendre`` reference file.

    The internal replacement for the external solid-waffle linearity
    run (whose JSON config ``calib.swconfig.linearity_config`` emits).
    Optional ``pflat``/``dark_slope`` planes are carried into the tree
    as the reference files do.  The fit runs on ``device`` (default
    ``cuda``).
    """
    from . import ref_meta
    from ..io import asdf_lite

    fit = fit_linearity(ramps, t_arrays, sref_frame_value,
                        p_order=p_order, device=device, **kw)
    ny, nx = fit["Smin"].shape
    tree = {
        "roman": {
            "meta": ref_meta(
                "LINEARITYLEGENDRE", sca, "internal linearity fit",
                author="romanimpreprocess_tpu_torch.calib.characterize",
            ),
            "data": fit["data"],
            "dq": fit["dq"],
            "Smin": fit["Smin"],
            "Smax": fit["Smax"],
            "Sref": fit["Sref"],
            "pflat": (
                np.asarray(pflat, np.float32) if pflat is not None
                else np.ones((ny, nx), np.float32)
            ),
            "dark": (
                np.asarray(dark_slope, np.float32) if dark_slope is not None
                else np.zeros((ny, nx), np.float32)
            ),
            "ramperr": np.ones((2, ny, nx), np.uint16),
        }
    }
    asdf_lite.AsdfFile(tree).write_to(out_path)
    return out_path


def gain_from_mean_variance(flat_cube, superpixel=32, read_var=0.0,
                            device=None):
    """Photon-transfer gain per superpixel (e/DN), expanded full-frame.

    Uses consecutive-frame differences of a flat ramp (= independent
    Poisson increments): mean m DN, variance m/g + 2 sigma_read^2, so
    g = m / (var - 2 read_var).  ``read_var`` (sigma_read^2, DN^2, e.g.
    from dark diffs) subtracts the read-noise floor; the reference's
    solid-waffle does the full correlation analysis — this is the
    classical photon-transfer estimate.  Runs on ``device`` (default
    ``cuda``); returns a host array.
    """
    dev = resolve_device(device)
    return _gain_core(
        _as_device(flat_cube, dev), float(np.float32(read_var)), superpixel=superpixel,
    ).cpu().numpy()


def _gain_core(flat_cube, read_var, *, superpixel):
    diffs = flat_cube[1:] - flat_cube[:-1]  # (nd, ny, nx) increments
    ny, nx = diffs.shape[-2:]
    k = superpixel
    nsy, nsx = ny // k, nx // k
    d = diffs[:, : nsy * k, : nsx * k].reshape(-1, nsy, k, nsx, k)
    # per-pixel temporal stats (spatial flat structure cancels), then
    # superpixel averages
    mean_pix = d.mean(0)
    var_pix = ((d - mean_pix) ** 2).mean(0)
    mean_sig = mean_pix.mean(dim=(1, 3))
    var_sig = var_pix.mean(dim=(1, 3)) - 2.0 * read_var
    gain_sp = mean_sig / torch.clamp(var_sig, min=1e-6)
    gain = gain_sp.repeat_interleave(k, 0).repeat_interleave(k, 1)
    out = torch.ones((ny, nx), dtype=torch.float32, device=flat_cube.device)
    out[: nsy * k, : nsx * k] = gain
    return out


def ipc_from_autocorr(flat_cube, nborder=4):
    """IPC alphas (alpha_h, alpha_v, alpha_d) from flat-difference
    nearest-neighbor autocorrelations.

    For shot noise passed through a small symmetric kernel K,
    C(d)/C(0) ~ 2 alpha_d to first order; returns scalar alphas
    (solid-waffle reports superpixel averages; the correlation method
    is intrinsically an average).
    """
    flat_cube = np.asarray(flat_cube, np.float64)
    diffs = flat_cube[1:] - flat_cube[:-1]
    nb = nborder
    d = diffs[:, nb:-nb, nb:-nb]
    d = d - d.mean(axis=(1, 2), keepdims=True)
    c0 = np.mean(d * d)
    ch = np.mean(d[:, :, 1:] * d[:, :, :-1])
    cv = np.mean(d[:, 1:, :] * d[:, :-1, :])
    cd = 0.5 * (
        np.mean(d[:, 1:, 1:] * d[:, :-1, :-1])
        + np.mean(d[:, 1:, :-1] * d[:, :-1, 1:])
    )
    return {
        "alphaH": float(ch / (2.0 * c0)),
        "alphaV": float(cv / (2.0 * c0)),
        "alphaD": float(cd / (2.0 * c0)),
    }
