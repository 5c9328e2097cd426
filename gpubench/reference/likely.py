"""Adaptive maximum-likelihood-style ramp fitting (the ``romancal_ramp_fit``
branch).

The reference's second fitter is romancal's likelihood ramp fit
(``ramp_fit_step.likely``, used via ``gen_cal_image.py:415-432``): a
GLS fit whose weights adapt to each pixel's own flux, with jump
rejection at a flat significance threshold, and ``dumo``/``chisq``
diagnostics:

- the per-pixel optimal weights are the Casertano et al. (2022) GLS
  solution evaluated on a **log-spaced grid of flux-to-noise ratios
  u** (the weights vary slowly in u, so a few bins per decade lose
  <1% statistical efficiency); each pixel looks its weights up by its
  (u bin, truncation variant) row index;
- variance quadratic forms are factored as
  ``var = K^T C K`` with ``C_P[a,b] = tau_a (a=b) | tbar_min(a,b)`` and
  ``C_R = diag(1/N)``.  Everything that depends only on the weight row
  -- ``K^T C K``, and for each pair ``d^T C d - 2 d^T C K + K^T C K`` --
  is a small per-row table built once per call, so a pixel's variances
  are lookups by its row index, not per-pixel dot products;
- jump rejection reuses the pair-difference significances, **two-sided**
  (the likelihood jump statistic is a chi^2 improvement, quadratic in
  the difference -- Brandt 2024, arXiv:2404.01326 -- unlike the classic
  weighted fitter's one-sided ``smap > sthresh`` cut, reference
  ``utils/fitting.py:249-251``); pixels with a jump are refit on the
  clean prefix (truncated GLS weights);
- ``chisq`` is the GLS chi-square of the adjacent resultant differences
  against the one-parameter ramp with the tridiagonal difference
  covariance, per degree of freedom (clean ramp => ~1), see
  :func:`gls_chisq`; ``dumo`` is the "dumb" slope, the two-point
  (last clean resultant - first) / delta tbar, slope-like in DN/s, so
  the calibration core flat-fields it before it is written; both are
  stored float16.

All data-dependent adaptivity is masked dense compute, no per-pixel
iteration.  Host math is float64; device maps are float32, every sum
over the group axis in a fixed order (no TF32 anywhere); DQ planes are
int32 bit patterns (:func:`..dqflags.i32`).
"""

from typing import NamedTuple

import numpy as np
import torch

from .dqflags import i32, pixel
from .ramp import (
    _pairs,
    casertano_weights,
    first_saturated_group,
    interior_mask,
    propagate_pdq,
    sqrt_rn,
)


def _cov_mats(meta):
    """C_P (Poisson) and C_R (read) covariance templates, float64."""
    ngrp = meta["ngrp"]
    tbar = meta["tbar"].astype(np.float64)
    tau = meta["tau"].astype(np.float64)
    C_P = np.empty((ngrp, ngrp))
    for a in range(ngrp):
        C_P[a, a] = tau[a]
        for b in range(a):
            C_P[a, b] = C_P[b, a] = tbar[b]
    C_R = np.diag(1.0 / meta["N"].astype(np.float64))
    return C_P, C_R


class LikelyPlan(NamedTuple):
    start: int
    ngrp: int
    nu: int  # u bins
    log_u0: float
    dlog_u: float
    m_of_variant: tuple  # truncation lengths (3+start .. ngrp)
    W: np.ndarray  # (nu, nvar, ngrp) GLS weights
    qP: np.ndarray  # (nu, nvar) K^T C_P K
    qR: np.ndarray  # (nu, nvar) K^T C_R K
    pairs: tuple
    inv_dtbar: np.ndarray  # (npairs,)
    pair_active: np.ndarray  # (nvar, npairs)
    c1P: np.ndarray  # (npairs,) d^T C_P d
    c1R: np.ndarray  # (npairs,) d^T C_R d
    vP: np.ndarray  # (npairs, ngrp) C_P d
    vR: np.ndarray  # (npairs, ngrp) C_R d
    tbar: np.ndarray  # (ngrp,)
    rejection_threshold: float
    # tridiagonal covariance templates of ADJACENT resultant
    # differences delta_i = R_{i+1} - R_i (Brandt 2024 chi^2; see
    # gls_chisq): Cov = dvardt * (aP, bP) + sig2read * (aR, bR)
    dt_diff: np.ndarray  # (ndiff,) tbar_{i+1} - tbar_i
    aP: np.ndarray  # (ndiff,) tau_i + tau_{i+1} - 2 tbar_i
    aR: np.ndarray  # (ndiff,) 1/N_i + 1/N_{i+1}
    bP: np.ndarray  # (ndiff-1,) tbar_{i+1} - tau_{i+1}
    bR: np.ndarray  # (ndiff-1,) -1/N_{i+1}


def build_likely_plan(meta, exclude_first=True, rejection_threshold=4.5,
                      nu=12, u_min=1e-4, u_max=30.0):
    """Host precomputation for the adaptive fitter."""
    start = 1 if exclude_first else 0
    ngrp = meta["ngrp"]
    ms = list(range(3 + start, ngrp)) + [ngrp]
    nvar = len(ms)
    log_u0 = np.log(u_min)
    dlog_u = (np.log(u_max) - np.log(u_min)) / (nu - 1)
    ubins = np.exp(log_u0 + dlog_u * np.arange(nu))

    C_P, C_R = _cov_mats(meta)

    W = np.zeros((nu, nvar, ngrp), np.float64)
    for b, u in enumerate(ubins):
        for v, m in enumerate(ms):
            # GLS weights on the first m groups at flux ratio u
            sub = {
                "ngrp": m,
                "N": meta["N"][:m],
                "tbar": meta["tbar"][:m],
                "tau": meta["tau"][:m],
            }
            W[b, v, :m] = casertano_weights(u, sub, exclude_first)

    qP = np.einsum("bvt,ts,bvs->bv", W, C_P, W)
    qR = np.einsum("bvt,ts,bvs->bv", W, C_R, W)

    base_pairs = _pairs(ngrp, start)
    npairs = len(base_pairs)
    inv_dtbar = np.array(
        [1.0 / (meta["tbar"][i + di] - meta["tbar"][i]) for i, di in base_pairs]
    )
    pair_active = np.zeros((nvar, npairs), bool)
    for v, m in enumerate(ms):
        act = set(_pairs(m, start))
        for p, pair in enumerate(base_pairs):
            pair_active[v, p] = pair in act

    d = np.zeros((npairs, ngrp))
    for p, (i, di) in enumerate(base_pairs):
        d[p, i + di] = inv_dtbar[p]
        d[p, i] = -inv_dtbar[p]
    c1P = np.einsum("pt,ts,ps->p", d, C_P, d)
    c1R = np.einsum("pt,ts,ps->p", d, C_R, d)
    vP = d @ C_P
    vR = d @ C_R

    # adjacent-difference covariance templates (delta_i = R_{i+1}-R_i,
    # i = 0..ngrp-2): from Cov(R_a,R_b) = a*C_P[a,b] + sig^2*C_R[a,b],
    #   Var(delta_i)          = a (tau_i + tau_{i+1} - 2 tbar_i)
    #                           + sig^2 (1/N_i + 1/N_{i+1})
    #   Cov(delta_i, delta_{i+1}) = a (tbar_{i+1} - tau_{i+1})
    #                           - sig^2 / N_{i+1}
    tbar64 = meta["tbar"].astype(np.float64)
    tau64 = meta["tau"].astype(np.float64)
    N64 = meta["N"].astype(np.float64)
    dt_diff = tbar64[1:] - tbar64[:-1]
    aP = tau64[:-1] + tau64[1:] - 2.0 * tbar64[:-1]
    aR = 1.0 / N64[:-1] + 1.0 / N64[1:]
    bP = tbar64[1:-1] - tau64[1:-1]
    bR = -1.0 / N64[1:-1]

    return LikelyPlan(
        start=start, ngrp=ngrp, nu=nu, log_u0=float(log_u0),
        dlog_u=float(dlog_u), m_of_variant=tuple(ms),
        W=W.astype(np.float32),
        qP=qP.astype(np.float32), qR=qR.astype(np.float32),
        pairs=tuple(base_pairs), inv_dtbar=inv_dtbar.astype(np.float32),
        pair_active=pair_active,
        c1P=c1P.astype(np.float32), c1R=c1R.astype(np.float32),
        vP=vP.astype(np.float32), vR=vR.astype(np.float32),
        tbar=meta["tbar"].astype(np.float32),
        rejection_threshold=float(rejection_threshold),
        dt_diff=dt_diff.astype(np.float32),
        aP=aP.astype(np.float32), aR=aR.astype(np.float32),
        bP=bP.astype(np.float32), bR=bR.astype(np.float32),
    )


def _table(t, dev):
    return torch.as_tensor(np.asarray(t, np.float32), device=dev)


def gls_chisq(data, plan, m_eff, dvardt, sig2read):
    """Per-dof GLS chi-square of the ramp, pinned to the likelihood
    fitter's published formulation (Brandt 2024, arXiv:2404.01326,
    eqs. 11-14; stcal ``likely_fit``): with adjacent resultant
    differences delta_i = R_{i+1} - R_i, tridiagonal covariance C
    (templates in the plan, evaluated at the fitted rate), and the
    one-parameter model E[delta] = a * dt,

        chi^2 = delta^T C^-1 delta
                - (dt^T C^-1 delta)^2 / (dt^T C^-1 dt),

    i.e. the GLS residual after profiling out the rate -- NOT a sum of
    independent pair significances (differences sharing a resultant
    are correlated).  Returned per degree of freedom
    (n_active_diffs - 1) so a clean ramp reads ~1.

    Masked dense compute: differences outside [start, m_eff-2] are
    deactivated by rewriting their tridiagonal row to the identity with
    zero rhs (a fixed ``ngrp-1``-step Thomas solve, no data-dependent
    shapes).  ``m_eff``: per-pixel one-past-the-last clean resultant.
    """
    ngrp = data.shape[0]
    dev = data.device
    start = plan.start
    nd = ngrp - 1  # template length; rows < start are always inactive
    ii = torch.arange(nd, device=dev)[:, None, None]
    act = (ii >= start) & (ii <= (m_eff - 2)[None])  # (nd, ny, nx)

    delta = data[1:] - data[:-1]  # (nd, ny, nx)
    dta = _table(plan.dt_diff, dev)[:, None, None]
    alpha = (
        _table(plan.aP, dev)[:, None, None] * dvardt[None]
        + _table(plan.aR, dev)[:, None, None] * sig2read[None]
    )
    beta = (
        _table(plan.bP, dev)[:, None, None] * dvardt[None]
        + _table(plan.bR, dev)[:, None, None] * sig2read[None]
    )
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # masked rows: identity diagonal, zero coupling, zero rhs
    alpha = torch.where(act, torch.clamp(alpha, min=1e-30), one)
    both = act[:-1] & act[1:]
    beta = torch.where(both, beta, zero)
    r1 = torch.where(act, delta, zero)
    r2 = torch.where(act, dta.expand_as(delta), zero)
    del delta, both

    # Thomas factorization shared by both right-hand sides (nd is a
    # small static count)
    cp = [None] * nd
    d1 = [None] * nd
    d2 = [None] * nd
    denom = alpha[0]
    cp[0] = beta[0] / denom if nd > 1 else None
    d1[0] = r1[0] / denom
    d2[0] = r2[0] / denom
    for i in range(1, nd):
        denom = alpha[i] - beta[i - 1] * cp[i - 1]
        if i < nd - 1:
            cp[i] = beta[i] / denom
        d1[i] = (r1[i] - beta[i - 1] * d1[i - 1]) / denom
        d2[i] = (r2[i] - beta[i - 1] * d2[i - 1]) / denom
    x1 = [None] * nd
    x2 = [None] * nd
    x1[nd - 1] = d1[nd - 1]
    x2[nd - 1] = d2[nd - 1]
    for i in range(nd - 2, -1, -1):
        x1[i] = d1[i] - cp[i] * x1[i + 1]
        x2[i] = d2[i] - cp[i] * x2[i + 1]

    def dot(r, x):  # sum over the differences, in order
        out = r[0] * x[0]
        for i in range(1, nd):
            out = out + r[i] * x[i]
        return out

    q_dd = dot(r1, x1)  # delta^T C^-1 delta
    q_td = dot(r2, x1)  # dt^T C^-1 delta
    q_tt = dot(r2, x2)  # dt^T C^-1 dt
    chi2 = q_dd - q_td * q_td / torch.clamp(q_tt, min=1e-30)
    dof = act.sum(dim=0).to(torch.float32) - 1.0
    return torch.where(dof >= 1.0, chi2 / torch.clamp(dof, min=1.0), zero)


def ramp_fit_likely(data, rdq, pdq, plan, gain, read_sigma, nborder=4, interior=None):
    """Adaptive-weight ramp fit with jump rejection and diagnostics.

    Same I/O contract as :func:`.ramp.ramp_fit` (``interior`` included)
    plus ``dumo`` and ``chisq`` maps: returns (slope, err_read, err_poisson, rdq, pdq,
    dumo, chisq).
    """
    ngrp, ny, nx = data.shape
    dev = data.device
    start = plan.start
    nvar = len(plan.m_of_variant)
    nu = plan.nu
    nb = nborder
    shape = (ny, nx)

    gain_c = torch.clamp(gain, 1e-4, 1e4)
    sig2read = read_sigma * read_sigma
    diffs = data - data[1][None]

    firstsat = first_saturated_group(rdq)
    in_layer = (firstsat >= 3 + start) & (firstsat <= ngrp - 1)
    eligible = in_layer | (firstsat == ngrp)
    last_var = torch.full_like(firstsat, nvar - 1)
    v_idx0 = torch.where(in_layer, firstsat - (3 + start), last_var).long()

    # weight rows by flat (u bin, variant) index, one table per group so
    # a pixel's weights are ngrp lookups; row-only functions of the
    # weights are tables too
    Wf = _table(plan.W.reshape(nu * nvar, ngrp), dev)
    W_t = Wf.t().contiguous()  # (ngrp, nu * nvar)
    qP_t = _table(plan.qP.ravel(), dev)
    qR_t = _table(plan.qR.ravel(), dev)

    def wsum(rows):
        """sum_t W[rows, t] * diffs[t], the groups in order."""
        out = W_t[0][rows] * diffs[0]
        for t in range(1, ngrp):
            out = out + W_t[t][rows] * diffs[t]
        return out

    # --- initial slope: central-u weights of each pixel's variant ---
    slope = wsum((nu // 2) * nvar + v_idx0)

    def u_bin_of(s):
        u = torch.clamp(s, min=1e-6) / (gain_c * sig2read)
        b = (torch.log(u) - plan.log_u0) / plan.dlog_u
        return torch.clamp(torch.round(b), 0, nu - 1).long()

    def fit(v_idx, slope_for_u):
        flat_idx = u_bin_of(slope_for_u) * nvar + v_idx
        return wsum(flat_idx), flat_idx

    # refine the u estimate once (weights vary slowly in u)
    slope, _ = fit(v_idx0, slope)
    slope, flat_idx = fit(v_idx0, slope)
    qP = qP_t[flat_idx]
    qR = qR_t[flat_idx]

    dvardt = torch.clamp(slope / gain_c, min=0.0)

    # --- jump detection: pair significances with factored variances ---
    if interior is None:
        interior = interior_mask(ny, nx, nb, dev)
    flag_ok = eligible & interior
    thresh = plan.rejection_threshold

    # per weight row and pair: var(ds) = d^T C d - 2 d^T C K + K^T C K,
    # Poisson and read parts, each sum over the groups in order
    def row_dots(v):  # (npairs, ngrp) -> (npairs, nu * nvar)
        v = _table(v, dev)
        out = v[:, 0, None] * W_t[0][None]
        for t in range(1, ngrp):
            out = out + v[:, t, None] * W_t[t][None]
        return out

    varP_t = _table(plan.c1P, dev)[:, None] - 2.0 * row_dots(plan.vP) + qP_t[None]
    varR_t = _table(plan.c1R, dev)[:, None] - 2.0 * row_dots(plan.vR) + qR_t[None]
    # pair p active for the row's variant
    act_t = torch.as_tensor(np.tile(plan.pair_active.T, (1, nu)), device=dev)

    group_hits = [None] * ngrp
    best_s2 = torch.zeros(shape, dtype=torch.float32, device=dev)
    best_boundary = torch.full(shape, ngrp, dtype=torch.int32, device=dev)
    for p, (i, di) in enumerate(plan.pairs):
        ds = (data[i + di] - data[i]) * float(plan.inv_dtbar[p]) - slope
        var = torch.clamp(
            varP_t[p][flat_idx] * dvardt + varR_t[p][flat_idx] * sig2read,
            min=1e-30,
        )
        s2 = (ds * ds) / var
        # Two-sided rejection: the likelihood fitter's jump statistic is
        # the chi^2 improvement from masking a pair difference (Brandt
        # 2024), which is quadratic in ds and so flags negative outliers
        # too.  (The classic weighted fitter is deliberately one-sided;
        # the two fitters differ here by design.)
        hit = (s2 > thresh * thresh) & act_t[p][flat_idx] & flag_ok
        group_hits[i] = hit if group_hits[i] is None else group_hits[i] | hit
        if di == 1:
            # jump localization: the most significant ADJACENT pair
            # brackets the jump (a large jump contaminates the global
            # slope, so every pair can exceed threshold; the spanning
            # pair dominates)
            take = hit & (s2 > best_s2)
            best_boundary = torch.where(
                take, torch.full_like(best_boundary, i), best_boundary)
            best_s2 = torch.where(take, s2, best_s2)
    del ds, var, s2, best_s2

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    jump = i32(pixel.JUMP_DET)
    jump_bits = torch.stack([
        torch.where(h, jump, zero) if h is not None
        else torch.zeros(shape, dtype=torch.int32, device=dev)
        for h in group_hits
    ])
    rdq_out = rdq | jump_bits
    del jump_bits

    # --- refit jump-affected pixels on the clean prefix ---
    # Prefer the argmax adjacent-pair boundary; if only wider (di=2)
    # pairs tripped, fall back to the earliest hit group.
    first_hit = torch.full(shape, ngrp, dtype=torch.int32, device=dev)
    for i in reversed(range(ngrp)):
        if group_hits[i] is not None:
            first_hit = torch.where(
                group_hits[i], torch.full_like(first_hit, i), first_hit)
    del group_hits
    jump_grp = torch.where(best_boundary < ngrp, best_boundary, first_hit)
    m_eff = torch.minimum(firstsat, jump_grp + 1)
    refit_layer = (m_eff >= 3 + start) & (m_eff <= ngrp - 1)
    v_idx1 = torch.where(refit_layer, m_eff - (3 + start), last_var).long()
    slope1, flat1 = fit(v_idx1, slope)
    use_refit = refit_layer & (jump_grp < ngrp)
    slope = torch.where(use_refit, slope1, slope)
    flat_idx = torch.where(use_refit, flat1, flat_idx)
    del slope1, flat1, diffs
    qP = qP_t[flat_idx]
    qR = qR_t[flat_idx]
    dvardt = torch.clamp(slope / gain_c, min=0.0)
    # a jump too early for ANY truncation variant (m_eff < 3+start)
    # leaves no clean prefix: the full-ramp slope stays contaminated.
    # The reference likelihood fitter masks the jump and refits the
    # remaining segment; a prefix fitter cannot, so the honest output
    # is DO_NOT_USE (analog of the classic fitter's fast-saturation
    # DNU, reference fitting.py:349).
    unusable_jump = (jump_grp < ngrp) & ~refit_layer

    slope_err_poisson = sqrt_rn(torch.clamp(qP * dvardt, min=0.0))
    slope_err_read = read_sigma * sqrt_rn(qR)

    # --- chisq of the FINAL fit (post-refit active set: refit pixels
    # report the clean prefix's goodness-of-fit, consistent with dumo);
    # the covariance is evaluated at the final fitted rate ---
    chisq = gls_chisq(data, plan, m_eff, dvardt, sig2read.expand(shape))

    # --- diagnostics ---
    # dumo: "dumb" two-point slope (last clean resultant - first) over
    # the usable ramp, slope-like so downstream flat-fields it
    end_idx = torch.clamp(m_eff - 1, start + 1, ngrp - 1).long()
    last = torch.gather(data, 0, end_idx[None])[0]
    inv_dt = np.zeros(ngrp, np.float32)
    for e in range(start + 1, ngrp):
        inv_dt[e] = 1.0 / (plan.tbar[e] - plan.tbar[start])
    dumo = (last - data[start]) * _table(inv_dt, dev)[end_idx]

    # --- pixel DQ propagation (shared rules, ramp.propagate_pdq) ---
    pdq_out = propagate_pdq(rdq_out, pdq, start)
    not_ref = (pdq & i32(pixel.REFERENCE_PIXEL)) == 0
    pdq_out = pdq_out | torch.where(
        unusable_jump & not_ref, i32(pixel.DO_NOT_USE), zero)

    return slope, slope_err_read, slope_err_poisson, rdq_out, pdq_out, dumo, chisq
