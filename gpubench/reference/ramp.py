"""Up-the-ramp slope fitting with jump detection.

Re-implements the algorithms of the reference's ``utils/fitting.py``
(``construct_weights:20``, ``jump_detect:89``, ``ramp_fit:258``;
Casertano et al. 2022 optimal weights, Sharma & Casertano 2024 jump
flagging).  Everything data-independent is precomputed on the host in
float64 -- the per-variant weight matrix ``W[v, t]``, and for every
(variant, pair) the scalar Poisson/read variance coefficients

    var(delta_slope) = A[v, p] * dvardt + B[v, p] * sig2read

(the per-pixel maps ``dvardt`` and ``sig2read`` factor out of the
reference's accumulation loops).  On the device all candidate slopes
come from one matrix product over the pixel axis, each pixel's
truncation variant is picked by indexing with its first-saturated-group
index, and each pair's significance map is a few elementwise ops.

Host math is float64; device maps are float32; DQ planes are int32 bit
patterns (:func:`..dqflags.i32`).
"""

from typing import NamedTuple

import numpy as np
import torch

from .dqflags import group as gdq
from .dqflags import i32, pixel
from .sky import full_fp32, mm


# --------------------------------------------------------------------------
# Host-side metadata (static per MA table)
# --------------------------------------------------------------------------

def ma_table_meta(read_pattern, frame_time):
    """Casertano et al. 2022 resultant statistics for an MA table.

    Returns dict with ``ngrp``, and per-group ``N`` (reads averaged),
    ``tbar`` (mean time), ``tau`` (variance-weighted time) — the same
    definitions as reference ``initializationstep``
    (``gen_cal_image.py:129-141``).
    """
    ngrp = len(read_pattern)
    N = np.zeros(ngrp, dtype=np.int64)
    tbar = np.zeros(ngrp)
    tau = np.zeros(ngrp)
    for i, grp in enumerate(read_pattern):
        n = len(grp)
        t0 = grp[0]
        N[i] = n
        tbar[i] = (t0 + (n - 1) / 2.0) * frame_time
        tau[i] = (t0 + (n - 1) * (2 * n - 1) / (6.0 * n)) * frame_time
    return {
        "ngrp": ngrp,
        "N": N,
        "tbar": tbar,
        "tau": tau,
        "frame_time": frame_time,
        "read_pattern": [list(g) for g in read_pattern],
    }


def casertano_weights(u, meta, exclude_first=True):
    """Optimal zero-sum slope weights K (length ngrp, float32).

    ``u = flux / (gain * sigma_read^2)`` in 1/(e s).  Covariance of the
    resultants (relative units): ``C[i,i] = 1/N_i + u tau_i``,
    ``C[i,j] = u tbar_min(i,j)``; the returned K solves the GLS slope
    normal equations and sums to zero (insensitive to the reset level).
    Reference: ``fitting.py:20-86``.
    """
    start = 1 if exclude_first else 0
    ngrp = meta["ngrp"] - start
    tbar = meta["tbar"][start:].astype(np.float64)
    tau = meta["tau"][start:].astype(np.float64)
    N = meta["N"][start:]
    C = np.empty((ngrp, ngrp))
    for i in range(ngrp):
        C[i, i] = 1.0 / N[i] + u * tau[i]
        for j in range(i):
            C[i, j] = C[j, i] = u * tbar[j]
    W = np.linalg.inv(C)
    Ws = W.sum(axis=0)
    Wt = W @ tbar
    F0 = W.sum()
    F1 = Wt.sum()
    F2 = tbar @ Wt
    D = F0 * F2 - F1 * F1
    K = np.zeros(meta["ngrp"])
    K[start:] = (F0 * Wt - F1 * Ws) / D
    return K.astype(np.float32)


def truncated_weights(meta, iend, exclude_first=True):
    """Two-point slope weights for a ramp truncated at group ``iend``.

    For bright (saturating) sources the fit uses the first and last
    usable resultants only (reference ``fitting.py:165-169``).
    """
    start = 1 if exclude_first else 0
    K = np.zeros(meta["ngrp"], dtype=np.float64)
    K[iend - 1] = 1.0 / (meta["tbar"][iend - 1] - meta["tbar"][start])
    K[start] = -K[iend - 1]
    return K.astype(np.float32)


def _pairs(m, start):
    """(i, di) double-difference pairs for a ramp of m usable groups.

    di in {1, 2}; i + di <= m-1; the (start, 2) pair is dropped for
    3-sample ramps where it is degenerate with the slope (this encodes
    the reference's ``dimax`` logic, ``fitting.py:226-228``).
    """
    out = []
    for i in range(start, m - 1):
        for di in (1, 2):
            if i + di > m - 1:
                continue
            if di == 2 and m - start == 3:
                continue
            out.append((i, di))
    return out


def _var_coeffs(w, meta):
    """Scalar variance coefficients (A_poisson, B_read) of sum_t w_t R_t.

    var = A * dvardt + B * sig2read with the per-pixel maps factored
    out; A and B are the reference's accumulation loops
    (``fitting.py:237-241``) evaluated once in float64.
    """
    tau = meta["tau"].astype(np.float64)
    tbar = meta["tbar"].astype(np.float64)
    N = meta["N"].astype(np.float64)
    w = w.astype(np.float64)
    A = np.sum(w * w * tau)
    for a in range(len(w)):
        for b in range(a):
            A += 2.0 * w[a] * w[b] * tbar[b]
    B = np.sum(w * w / N)
    return A, B


class RampFitPlan(NamedTuple):
    """All data-independent precomputation for one MA table + config.

    Variant v covers truncation lengths m in [3+start, ngrp-1] plus the
    full-ramp Casertano fit at v = nvar-1 (m = ngrp).
    """

    start: int  # 1 if exclude_first
    ngrp: int
    m_of_variant: tuple  # length nvar, usable-group count per variant
    W: np.ndarray  # (nvar, ngrp) slope weights, f32
    coef_poisson: np.ndarray  # (nvar,) slope Poisson variance coefficient
    rd_coef: np.ndarray  # (nvar,) sqrt(sum K^2 / N) read-noise coefficient
    pairs: tuple  # ((i, di), ...) base pair list
    inv_dtbar: np.ndarray  # (npairs,) 1 / (tbar[i+di] - tbar[i])
    pair_active: np.ndarray  # (nvar, npairs) bool
    A: np.ndarray  # (nvar, npairs) Poisson var coefficient
    B: np.ndarray  # (nvar, npairs) read var coefficient
    sthresh_a: float
    sthresh_b: float
    ithresh_a: float
    ithresh_b: float


def build_plan(meta, u, exclude_first=True, jump_pars=None):
    """Precompute the ramp-fit/jump-detection plan on the host."""
    jp = dict(SthreshA=5.5, SthreshB=4.5, IthreshA=1.0, IthreshB=1000.0)
    if jump_pars:
        jp.update({k: float(v) for k, v in jump_pars.items()})
    start = 1 if exclude_first else 0
    ngrp = meta["ngrp"]

    ms = list(range(3 + start, ngrp)) + [ngrp]
    nvar = len(ms)
    W = np.zeros((nvar, ngrp), dtype=np.float32)
    coef_p = np.zeros(nvar)
    rd = np.zeros(nvar)
    for v, m in enumerate(ms):
        K = (
            casertano_weights(u, meta, exclude_first)
            if m == ngrp
            else truncated_weights(meta, m, exclude_first)
        )
        W[v] = K
        A, B = _var_coeffs(K, meta)
        coef_p[v] = A
        rd[v] = np.sqrt(B)

    base_pairs = _pairs(ngrp, start)
    npairs = len(base_pairs)
    inv_dtbar = np.array(
        [1.0 / (meta["tbar"][i + di] - meta["tbar"][i]) for i, di in base_pairs]
    )
    pair_active = np.zeros((nvar, npairs), dtype=bool)
    Ap = np.zeros((nvar, npairs))
    Bp = np.zeros((nvar, npairs))
    for v, m in enumerate(ms):
        active = set(_pairs(m, start))
        for p, (i, di) in enumerate(base_pairs):
            if (i, di) not in active:
                continue
            pair_active[v, p] = True
            w = np.zeros(ngrp)
            w[i + di] = inv_dtbar[p]
            w[i] = -inv_dtbar[p]
            w -= W[v].astype(np.float64)
            Ap[v, p], Bp[v, p] = _var_coeffs(w, meta)

    return RampFitPlan(
        start=start,
        ngrp=ngrp,
        m_of_variant=tuple(ms),
        W=W,
        coef_poisson=coef_p.astype(np.float32),
        rd_coef=rd.astype(np.float32),
        pairs=tuple(base_pairs),
        inv_dtbar=inv_dtbar.astype(np.float32),
        pair_active=pair_active,
        A=Ap.astype(np.float32),
        B=Bp.astype(np.float32),
        sthresh_a=jp["SthreshA"],
        sthresh_b=jp["SthreshB"],
        ithresh_a=jp["IthreshA"],
        ithresh_b=jp["IthreshB"],
    )


# --------------------------------------------------------------------------
# Device-side fit
# --------------------------------------------------------------------------

def candidate_slopes(W, diffs):
    """Every variant's slope, ``W @ diffs`` over the pixel axis, in full
    float32.  The fit's one step whose order of summation neither
    package sets: a BLAS product (XLA's order on the CPU changes with
    the pixel count)."""
    with full_fp32():
        return mm(W, diffs)


def sqrt_rn(x):
    """The correctly rounded square root of a float32 tensor, as IEEE
    (and the reference) defines it.  PyTorch's float32 square root on
    the CPU (a vector math library's) rounds some 0.7% of the values one
    ulp low; taken in float64 and rounded once to float32 the root is
    exact to the last bit, on every device."""
    return torch.sqrt(x.double()).to(x.dtype)


def first_saturated_group(rdq):
    """Per-pixel index of the first SATURATED group (ngrp if none)."""
    ngrp = rdq.shape[0]
    sat = ((rdq & i32(gdq.SATURATED)) != 0).to(torch.int32)
    idx = torch.argmax(sat, dim=0).to(torch.int32)  # first max; 0 if none
    ngrp_t = torch.full_like(idx, ngrp)
    return torch.where(sat.any(dim=0), idx, ngrp_t)


def interior_mask(ny, nx, nb, device=None):
    """Boolean (ny, nx) mask of the non-border interior (``nb == 0``
    gives the whole frame)."""
    mask = torch.zeros((ny, nx), dtype=torch.bool, device=device)
    mask[nb : ny - nb, nb : nx - nb] = True
    return mask


def _or_reduce(planes):
    out = planes[0]
    for p in planes[1:]:
        out = out | p
    return out


def propagate_pdq(rdq_out, pdq, start):
    """Group-DQ -> pixel-DQ propagation (reference ``fitting.py:339-353``):
    OR of unsaturated groups' flags; DO_NOT_USE only if ALL groups carry
    it or the first used group is already saturated; SATURATED always
    propagates; reference pixels keep their DQ untouched."""
    dnu = i32(pixel.DO_NOT_USE)
    sat = i32(pixel.SATURATED)
    zero = torch.zeros((), dtype=torch.int32, device=pdq.device)
    not_sat_grp = (rdq_out & sat) == 0
    pdq2 = _or_reduce(torch.where(not_sat_grp, rdq_out, zero)) & ~dnu
    all_dnu = ((rdq_out & dnu) != 0).all(dim=0)
    pdq2 = pdq2 | torch.where(all_dnu, dnu, zero)
    pdq2 = pdq2 | torch.where((rdq_out[1 + start] & sat) != 0, dnu, zero)
    pdq2 = pdq2 | _or_reduce(rdq_out & sat)
    not_ref = (pdq & i32(pixel.REFERENCE_PIXEL)) == 0
    return pdq | torch.where(not_ref, pdq2, zero)


def ramp_fit(data, rdq, pdq, plan, gain, read_sigma, nborder=4, interior=None):
    """Fit slopes, detect jumps, and propagate flags.

    Parameters
    ----------
    data : (ngrp, ny, nx) float32, linearized + IPC-corrected DN.
    rdq : (ngrp, ny, nx) int32 group DQ (SATURATED, DO_NOT_USE...).
    pdq : (ny, nx) int32 pixel DQ.
    plan : RampFitPlan (host-precomputed).
    gain : (ny, nx) e/DN.
    read_sigma : (ny, nx) single-read noise std, DN.
    nborder : border width excluded from jump flagging.
    interior : optional (ny, nx) boolean mask of the pixels that may be
        jump-flagged, in place of the frame's interior by ``nborder``
        (a row slab of a frame passes the frame's interior at its rows).

    Returns slope, slope_err_read, slope_err_poisson ((ny, nx) float32,
    DN/s), rdq with JUMP_DET bits, and pdq with the propagated flags.

    - unsaturated pixels: full Casertano fit + jump flags,
    - pixels first saturated at group m in [3+start, ngrp-1]: two-point
      truncated fit + jump flags from the truncated pair set,
    - earlier saturation: base-fit values kept, no jump flags,
      DO_NOT_USE when saturated by group 1+start.
    """
    ngrp, ny, nx = data.shape
    start = plan.start
    nvar = len(plan.m_of_variant)
    dev = data.device

    def table(t):
        return torch.as_tensor(np.asarray(t, np.float32), device=dev)

    firstsat = first_saturated_group(rdq)
    in_layer = (firstsat >= 3 + start) & (firstsat <= ngrp - 1)
    eligible = in_layer | (firstsat == ngrp)  # pixels that get jump flags
    # variant row per pixel: truncation m = firstsat -> v = m - (3+start);
    # the base fit is the last row
    v_idx = torch.where(in_layer, firstsat - (3 + start),
                        torch.full_like(firstsat, nvar - 1)).long()

    # --- all candidate slopes: one product over the pixel axis ---
    diffs = (data - data[1][None]).reshape(ngrp, ny * nx)
    slopes_all = candidate_slopes(table(plan.W), diffs).reshape(nvar, ny, nx)
    slope = torch.gather(slopes_all, 0, v_idx[None])[0]

    coef_sel = table(plan.coef_poisson)[v_idx]
    rd_sel = table(plan.rd_coef)[v_idx]

    gain_c = torch.clamp(gain, 1e-4, 1e4)
    dvardt = torch.clamp(slope / gain_c, min=0.0)  # Poisson var (DN^2) per s
    sig2read = read_sigma * read_sigma

    slope_err_poisson = sqrt_rn(torch.clamp(coef_sel * dvardt, min=0.0))
    slope_err_read = read_sigma * rd_sel

    # --- flux-dependent jump threshold (log-interpolated) ---
    x = torch.clamp(slope, plan.ithresh_a, plan.ithresh_b)
    x = torch.log(x / plan.ithresh_a) / float(np.log(plan.ithresh_b / plan.ithresh_a))
    sthresh = plan.sthresh_a + (plan.sthresh_b - plan.sthresh_a) * x

    # --- per-pair significance + flagging ---
    if interior is None:
        interior = interior_mask(ny, nx, nborder, dev)
    flag_ok = eligible & interior
    A_t, B_t = table(plan.A), table(plan.B)
    act_t = torch.as_tensor(plan.pair_active, device=dev)
    group_hits = [None] * ngrp
    for p, (i, di) in enumerate(plan.pairs):
        ds = (data[i + di] - data[i]) * float(plan.inv_dtbar[p]) - slope
        var = A_t[:, p][v_idx] * dvardt + B_t[:, p][v_idx] * sig2read
        s = ds * torch.rsqrt(var)
        hit = (s > sthresh) & act_t[:, p][v_idx] & flag_ok
        group_hits[i] = hit if group_hits[i] is None else (group_hits[i] | hit)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    jump = i32(pixel.JUMP_DET)
    jump_bits = torch.stack([
        torch.where(h, jump, zero) if h is not None
        else torch.zeros((ny, nx), dtype=torch.int32, device=dev)
        for h in group_hits
    ])
    rdq_out = rdq | jump_bits
    pdq_out = propagate_pdq(rdq_out, pdq, start)
    return slope, slope_err_read, slope_err_poisson, rdq_out, pdq_out
