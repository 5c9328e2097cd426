"""Vectorized Pearson-family deviates matching target ramp-noise moments.

Given the scalar nu-tilde moment ratios of a weighted ramp fit and a
per-pixel intensity map I (electrons), draws one zero-mean deviate per
pixel whose variance/skew/kurtosis reproduce the Poisson-propagated
ramp-fit noise:

    mu2    = tilnu_21 * I
    beta1  = tilnu_31^2 / (tilnu_21^3 * I)
    beta2  = (3 tilnu_21^2 * I + tilnu_41) / (tilnu_21^2 * I)

and dispatches on the Pearson (beta1, beta2) plane: Type I (beta),
III (gamma), VI (beta-prime), V (inverse-gamma), IV (Heinrich 2004).

Same admissibility regions, parameter solutions, and samplers as the
reference (``GalPoisson/draw_with_tilnus.py``), but *fully vectorized*:
the reference draws Type-IV deviates in a per-pixel Python loop
(``draw_with_tilnus.py:580-584``); here Devroye rejection runs as
batched rounds over all pending pixels, with the Heinrich
acceptance-rate predictor routing hopeless pixels to the
mixture-proposal accept-reject sampler (also batched).
"""

import numpy as np
from scipy.special import betaln, gammainc, loggamma
from scipy.stats import invgamma as sp_invgamma
from scipy.stats import t as sp_t

__all__ = ["draw_from_pearson"]


def _betas(tilnu_21, tilnu_31, tilnu_41, I):
    beta1 = tilnu_31**2 / (tilnu_21**3 * I)
    beta2 = (3.0 * tilnu_21**2 * I + tilnu_41) / (tilnu_21**2 * I)
    return beta1, beta2


# -- Type I: shifted/scaled Beta -------------------------------------------

def _draw_type1(tilnu_21, tilnu_31, tilnu_41, I, rng):
    beta1, beta2 = _betas(tilnu_21, tilnu_31, tilnu_41, I)
    # u = a+b and v = (a-b)^2/(ab) solve the beta1/beta2 system
    u = 3.0 * (beta1 - beta2 + 1.0) / ((beta2 - 3.0) - 1.5 * beta1)
    v = beta1 * (u + 2.0) ** 2 / (4.0 * (u + 1.0))
    s = np.sqrt(v / (v + 4.0))
    a_plus = 0.5 * u * (1.0 + s)
    b_plus = 0.5 * u * (1.0 - s)
    want_neg = tilnu_31 < 0
    cond = (a_plus > b_plus) if want_neg else (a_plus < b_plus)
    a = np.where(cond, a_plus, b_plus)
    b = np.where(cond, b_plus, a_plus)
    mean = a / (a + b)
    var = a * b / ((a + b) ** 2 * (a + b + 1.0))
    c = np.sqrt(tilnu_21 * I / var)
    y = rng.beta(a, b)
    return c * (y - mean)


# -- Type III: shifted/scaled Gamma ----------------------------------------

def _draw_type3(tilnu_21, tilnu_31, I, rng):
    scale = abs(tilnu_31) / (2.0 * tilnu_21)
    shape = 4.0 * tilnu_21**3 * I / tilnu_31**2
    sign = 1.0 if tilnu_31 > 0 else -1.0
    y = rng.standard_gamma(shape)
    return sign * (scale * y - shape * scale)


# -- Type V: shifted inverse-Gamma -----------------------------------------

def _draw_type5(tilnu_21, tilnu_31, I, rng):
    beta1, _ = _betas(tilnu_21, tilnu_31, 0.0, I)
    sqrt_t = np.sqrt(4.0 + beta1)
    p_plus = 4.0 * (1.0 + 2.0 / beta1 + sqrt_t / beta1)
    p_minus = 4.0 * (1.0 + 2.0 / beta1 - sqrt_t / beta1)
    p = np.where(p_plus > 4.0, p_plus, p_minus)
    sigma = np.sqrt(tilnu_21 * I)
    g5 = sigma * (p - 2.0) * np.sqrt(p - 3.0)
    a = p - 1.0
    mu = g5 / (a - 1.0)
    # InvGamma(a, scale=b) == b / Gamma(a)
    y = g5 / rng.standard_gamma(a)
    sign = 1.0 if tilnu_31 >= 0 else -1.0
    return sign * (y - mu)


# -- Type VI: shifted/scaled Beta-prime ------------------------------------

def _draw_type6(tilnu_21, tilnu_31, tilnu_41, I, rng):
    beta1, beta2 = _betas(tilnu_21, tilnu_31, tilnu_41, I)
    sign = 1.0 if tilnu_31 >= 0 else -1.0
    r = 6.0 * (beta2 - beta1 - 1.0) / (3.0 * beta1 - 2.0 * beta2 + 6.0)
    eps = r**2 / (4.0 + (beta1 / 4.0) * (r + 2.0) ** 2 / (r + 1.0))
    d = np.sqrt(r**2 - 4.0 * eps)
    q1 = (2.0 - r + d) / 2.0
    q2 = (r - 2.0 + d) / 2.0
    alpha = q2 + 1.0
    beta = q1 - q2 - 1.0
    var1 = alpha * (alpha + beta - 1.0) / ((beta - 2.0) * (beta - 1.0) ** 2)
    scale = np.sqrt(tilnu_21 * I / var1)
    shift = scale * alpha / (beta - 1.0)
    # BetaPrime(a, b) == Gamma(a) / Gamma(b)
    y = rng.standard_gamma(alpha) / rng.standard_gamma(beta)
    return sign * (scale * y - shift)


# -- Type IV ----------------------------------------------------------------

def _log_k(m, nu, a):
    """log of the Pearson-IV normalization (Heinrich 2004 eq. 5)."""
    return (
        (2.0 * m - 2.0) * np.log(2.0)
        + 2.0 * loggamma(m + 0.5j * nu).real
        - (np.log(np.pi) + np.log(a) + loggamma(2.0 * m - 1.0).real)
    )


def _type4_params(tilnu_21, tilnu_31, tilnu_41, I):
    beta1, beta2 = _betas(tilnu_21, tilnu_31, tilnu_41, I)
    mu2 = tilnu_21 * I
    r = 6.0 * (beta2 - beta1 - 1.0) / (2.0 * beta2 - 3.0 * beta1 - 6.0)
    inner = 16.0 * (r - 1.0) - beta1 * (r - 2.0) ** 2
    if np.any(r <= 1) or np.any(inner <= 0):
        raise ValueError("invalid Pearson-IV parameters")
    sign = -1.0 if tilnu_31 >= 0 else 1.0  # sign(mu3) = -sign(nu)
    nu = sign * r * (r - 2.0) * np.sqrt(beta1) / np.sqrt(inner)
    a = np.sqrt(mu2 * inner) / 4.0
    m = r / 2.0 + 1.0
    lam = a * nu / (2.0 * (m - 1.0))
    return m, nu, a, lam


def _devroye_acc_rate(m, nu, a):
    """Heinrich's analytic acceptance-rate estimate for the Devroye
    rejection sampler."""
    b = 2.0 * m - 2.0
    M = np.arctan2(-nu, b)
    cosM = b / np.hypot(b, nu)
    r_const = b * np.log(cosM) - nu * M
    rc = np.exp(-r_const - _log_k(m, nu, a))
    return (np.pi / (4.0 * rc)) * np.sqrt(
        2.0 / (np.pi * (2.0 * m + nu**2 / (2.0 * m)))
    )


def _devroye_batched(m, nu, a, lam, rng, max_rounds=2000):
    """Batched Devroye rejection (Heinrich 2004 §7) over all pixels.

    Each round proposes for every still-pending pixel simultaneously.
    Returns (draws, pending_mask) — pixels still pending after
    ``max_rounds`` are left for the caller's fallback.
    """
    n = m.shape[0]
    b = 2.0 * m - 2.0
    M = np.arctan2(-nu, b)
    cosM = b / np.hypot(b, nu)
    r_const = b * np.log(cosM) - nu * M
    rc = np.exp(-r_const - _log_k(m, nu, a))

    out = np.zeros(n)
    pending = np.ones(n, dtype=bool)
    for _ in range(max_rounds):
        idx = np.where(pending)[0]
        if idx.size == 0:
            break
        k = idx.size
        x = 4.0 * rng.random(k)
        s = x > 2.0
        x = np.where(s, x - 2.0, x)
        log_branch = x > 1.0
        z = np.where(log_branch, np.log(np.where(log_branch, x - 1.0, 1.0)), 0.0)
        x = np.where(log_branch, 1.0 - z, x)
        x = np.where(s, M[idx] + rc[idx] * x, M[idx] - rc[idx] * x)
        ok = np.abs(x) < np.pi / 2.0
        logu = np.log(rng.random(k))
        with np.errstate(invalid="ignore", divide="ignore"):
            crit = b[idx] * np.log(np.abs(np.cos(x))) - nu[idx] * x - r_const[idx]
        accept = ok & (z + logu <= crit)
        hit = idx[accept]
        out[hit] = a[hit] * np.tan(x[accept]) + lam[hit]
        pending[hit] = False
    return out, pending


def _ar_batched(m, nu, a, lam, rng, max_rounds=10000):
    """Batched accept-reject Pearson-IV sampler with the two-branch
    proposal g(s) (left: scaled Student-t; right: truncated
    inverse-gamma), peak-scaled at s=0.  Used for pixels where the
    Devroye acceptance rate is hopeless (reference
    ``pt4_rvs_ar``, ``draw_with_tilnus.py:486-518``).
    """
    n = m.shape[0]
    theta = nu / (2.0 * m)
    root = np.sqrt(1.0 + theta * theta)
    logk = _log_k(m, nu, a)
    log_dxds = np.log(a) + 0.5 * np.log1p(theta * theta)

    # branch masses of normalized g(s)
    alpha = 2.0 * m - 1.0
    log_P_left = np.log(0.5) + betaln(0.5, m - 0.5)
    P = gammainc(alpha, 2.0 * m)
    with np.errstate(divide="ignore"):
        log_P_right = (
            2.0 * m
            - (2.0 * m - 1.0) * np.log(2.0 * m)
            + loggamma(alpha).real
            + np.log(P)
        )
    logZ = np.logaddexp(log_P_left, log_P_right)
    g0 = np.exp(-logZ)
    w_left = np.exp(log_P_left - logZ)

    def log_fS(s, i):
        xi = root[i] * s - theta[i]
        return (
            logk[i] + log_dxds[i] - m[i] * np.log1p(xi * xi)
            - nu[i] * np.arctan(xi)
        )

    # peak scaling at s=0
    logc = np.maximum(0.0, log_fS(np.zeros(n), np.arange(n)) - np.log(g0))

    flip = nu > 0.0
    out = np.zeros(n)
    pending = np.ones(n, dtype=bool)
    tiny = np.nextafter(0.0, 1.0)
    for _ in range(max_rounds):
        idx = np.where(pending)[0]
        if idx.size == 0:
            break
        k = idx.size
        use_left = rng.random(k) < w_left[idx]
        s0 = np.empty(k)
        # left branch: negative half of scaled Student-t, df = 2m-1
        nl = int(use_left.sum())
        if nl:
            dfl = 2.0 * m[idx[use_left]] - 1.0
            T = sp_t.rvs(df=dfl, size=nl, random_state=rng)
            s0[use_left] = -np.abs(T / np.sqrt(dfl))
        # right branch: InvGamma(2m-1, scale=2m) truncated to y > 1
        nr = k - nl
        if nr:
            i_r = idx[~use_left]
            al = 2.0 * m[i_r] - 1.0
            be = 2.0 * m[i_r]
            logS1 = sp_invgamma.logsf(1.0, a=al, scale=be)
            U = np.maximum(rng.random(nr), tiny)
            Y = sp_invgamma.isf(
                np.maximum(np.exp(logS1 + np.log(U)), tiny), a=al, scale=be
            )
            s0[~use_left] = Y - 1.0

        s = np.where(flip[idx], -s0, s0)
        lf = log_fS(s, idx)
        neg = s0 < 0.0
        pos = s0 > 0.0
        lg = np.log(g0[idx]) + np.where(
            neg,
            -m[idx] * np.log1p(s0 * s0),
            np.where(
                pos,
                -2.0 * m[idx] * np.log1p(np.abs(s0))
                + (2.0 * m[idx] * s0) / (1.0 + np.abs(s0)),
                0.0,
            ),
        )
        log_alpha = lf - lg - logc[idx]
        accept = np.log(np.maximum(rng.random(k), tiny)) < np.minimum(
            log_alpha, 0.0
        )
        hit = idx[accept]
        xi = root[hit] * s[accept] - theta[hit]
        out[hit] = a[hit] * xi + lam[hit]
        pending[hit] = False
    # stragglers are returned for the caller's moment-matched fallback
    # (writing 0.0 here would silently inject zero noise)
    return out, pending


def _draw_type4(tilnu_21, tilnu_31, tilnu_41, I, rng,
                devroye_threshold=0.005):
    m, nu, a, lam = _type4_params(tilnu_21, tilnu_31, tilnu_41, I)
    acc = _devroye_acc_rate(m, nu, a)
    use_dev = acc > devroye_threshold
    out = np.zeros(I.shape[0])
    stuck = np.zeros(I.shape[0], bool)
    if np.any(use_dev):
        d, pend = _devroye_batched(
            m[use_dev], nu[use_dev], a[use_dev], lam[use_dev], rng
        )
        if np.any(pend):
            d[pend], pend2 = _ar_batched(
                m[use_dev][pend], nu[use_dev][pend], a[use_dev][pend],
                lam[use_dev][pend], rng,
            )
            sub = np.zeros(d.shape[0], bool)
            sub[pend] = pend2
            tmp = np.zeros(I.shape[0], bool)
            tmp[use_dev] = sub
            stuck |= tmp
        out[use_dev] = d
    if np.any(~use_dev):
        out[~use_dev], pend = _ar_batched(
            m[~use_dev], nu[~use_dev], a[~use_dev], lam[~use_dev], rng
        )
        tmp = np.zeros(I.shape[0], bool)
        tmp[~use_dev] = pend
        stuck |= tmp
    if np.any(stuck):
        # moment-matched normal for pixels both samplers failed to fill
        # (vanishingly rare): zero mean, target second moment
        # mu2 = tilnu_21 * I — NOT zero, which would bias the 'O' noise
        # layer variance low for exactly the hardest-parameter pixels
        out[stuck] = rng.normal(
            0.0, np.sqrt(np.maximum(tilnu_21 * I[stuck], 0.0))
        )
    return out


# -- dispatcher -------------------------------------------------------------

def draw_from_pearson(tilnu_21, tilnu_31, tilnu_41, I_arr, *, atol=0.0,
                      rng=None):
    """One zero-mean Pearson deviate per element of ``I_arr``.

    Elements outside the admissibility region draw 0 (as in the
    reference dispatcher, ``draw_with_tilnus.py:46-126``).
    """
    if rng is None or not hasattr(rng, "random"):
        rng = np.random.default_rng(rng)

    I = np.clip(np.asarray(I_arr, dtype=float), 0.01, None)
    shape = I.shape
    I = I.ravel()

    beta1, beta2 = _betas(tilnu_21, tilnu_31, tilnu_41, I)
    base = (beta2 > 0) & (beta1 >= 0) & (beta2 > beta1 + 1) & (beta2 > 0.75 * beta1)
    if not np.any(base):
        return np.zeros(shape)

    rhs1 = 1.5 * beta1 + 3.0
    rhs2 = (48.0 + 39.0 * beta1 + 6.0 * (4.0 + beta1) ** 1.5) / (32.0 - beta1)
    eq1 = np.isclose(beta2, rhs1, atol=atol, rtol=0)
    eq2 = np.isclose(beta2, rhs2, atol=atol, rtol=0)
    type1 = base & (beta2 < rhs1 - atol)
    type3 = base & eq1
    type5 = base & eq2
    type6 = base & (beta2 > rhs1 + atol) & (beta2 < rhs2 - atol)
    type4 = base & (beta2 > rhs2 + atol) & (beta1 < 32.0)

    draws = np.zeros(I.shape[0])
    if np.any(type1):
        draws[type1] = _draw_type1(tilnu_21, tilnu_31, tilnu_41, I[type1], rng)
    if np.any(type3):
        draws[type3] = _draw_type3(tilnu_21, tilnu_31, I[type3], rng)
    if np.any(type5):
        draws[type5] = _draw_type5(tilnu_21, tilnu_31, I[type5], rng)
    if np.any(type6):
        draws[type6] = _draw_type6(tilnu_21, tilnu_31, tilnu_41, I[type6], rng)
    if np.any(type4):
        draws[type4] = _draw_type4(tilnu_21, tilnu_31, tilnu_41, I[type4], rng)
    return draws.reshape(shape)
