"""Pearson-family samplers on a torch device.

Counterpart of the JAX package's device sampler
(``galpoisson/pearson_jax.py`` ``draw_from_pearson_jax``): the same
admissibility dispatch, parameter solutions, target moments and
constants as the reference (``GalPoisson/draw_with_tilnus.py:12-126``),
so that the noise engine's 'O' layer draws on the device that holds the
frame.  The host sampler is :func:`.pearson.draw_from_pearson`.

Execution shape:

- Types 1/3/5/6 are direct transforms of Beta/Gamma deviates, drawn on
  each type's lanes only (a boolean index), so a lane of another type
  or an inadmissible one never reaches a sampler.
- Type-4 lanes with ``m <= M_CF_CUT`` are compacted into chunks of
  ``rej_buf`` lanes and sampled by batched rejection: Devroye proposals
  (Heinrich 2004 section 7) where the predicted acceptance rate is at
  least ``ACC_AR_CUT``, the two-branch mixture accept-reject proposal
  elsewhere.  Each round draws for the pending lanes only and shrinks
  them to the ones that rejected, so a round costs what is left; the
  loop ends when none is left or after ``max_rounds``.  Each round reads
  the pending count on the host (one synchronisation); :data:`rounds`
  counts the rounds.
- Type-4 lanes with ``m > M_CF_CUT`` (nearly Gaussian, where the
  rejection constants lose float32 accuracy) and the rejection's
  stragglers take a variance-exact Cornish-Fisher draw.

Randomness: the one ``torch.Generator`` passed in is consumed in a
fixed order: type 1 (two gammas), 3, 5, 6 (two gammas), then type 4
(the Cornish-Fisher normals, then the rejection rounds chunk by chunk,
each round a uniform, a uniform, a uniform, a Student-t (normal, then
gamma), a gamma and a uniform); a type without lanes draws nothing.
The rejection consumes a data-dependent number of draws, so callers
give each draw a generator of its own.  Parity with the JAX sampler is
statistical (``tests/test_torch_galpoisson.py``).
"""

import math

import torch

from ..ops import rand

__all__ = ["draw_from_pearson_torch"]

#: type-4 lanes with m above this use the Cornish-Fisher path.
M_CF_CUT = 256.0
#: predicted Devroye acceptance below this routes a lane to the
#: mixture accept-reject proposal.
ACC_AR_CUT = 0.02
#: default rejection chunk width (lanes).  A whole 4088^2 frame is one
#: chunk: the card holds its lanes' state (a few hundred MB), and every
#: chunk costs its own rounds of host synchronisation.
REJ_BUF = 1 << 24

#: type-4 rejection rounds run since the last reset (set it to 0 to reset)
rounds = 0

_TINY = 1e-37

# -- complex log-gamma (real part) ------------------------------------------

_LANCZOS_G = 7.0
_LANCZOS = (
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
)


def _lgamma_re(x, y):
    """Re(loggamma(x + i*y)) for x >= 1 (Lanczos g=7, real arithmetic:
    torch has no complex lgamma)."""
    ar = torch.full_like(x, _LANCZOS[0])
    ai = torch.zeros_like(x)
    for k in range(1, 9):
        d = x - 1.0 + k
        den = d * d + y * y
        ar = ar + _LANCZOS[k] * d / den
        ai = ai - _LANCZOS[k] * y / den
    tx = x + (_LANCZOS_G - 0.5)
    return (
        0.5 * math.log(2.0 * math.pi)
        + (x - 0.5) * 0.5 * torch.log(tx * tx + y * y)
        - y * torch.atan2(y, tx)
        - tx
        + 0.5 * torch.log(ar * ar + ai * ai)
    )


def _log_k(m, nu, a):
    """log of the Pearson-IV normalization (Heinrich 2004 eq. 5)."""
    return (
        (2.0 * m - 2.0) * math.log(2.0)
        + 2.0 * _lgamma_re(m, 0.5 * nu)
        - (math.log(math.pi) + torch.log(a) + torch.lgamma(2.0 * m - 1.0))
    )


def _betas(t21, t31, t41, I):
    beta1 = t31 * t31 / (t21 * t21 * t21 * I)
    beta2 = (3.0 * t21 * t21 * I + t41) / (t21 * t21 * I)
    return beta1, beta2


# -- Types 1 / 3 / 5 / 6: transforms of Beta/Gamma draws, on their lanes -----

def _draw_type1(gen, t21, t31, t41, I):
    beta1, beta2 = _betas(t21, t31, t41, I)
    u = 3.0 * (beta1 - beta2 + 1.0) / ((beta2 - 3.0) - 1.5 * beta1)
    v = beta1 * (u + 2.0) ** 2 / (4.0 * (u + 1.0))
    v = torch.where(v >= 0, v, torch.zeros_like(v))
    s = torch.sqrt(v / (v + 4.0))
    a_plus = 0.5 * u * (1.0 + s)
    b_plus = 0.5 * u * (1.0 - s)
    cond = torch.where(t31 < 0, a_plus > b_plus, a_plus < b_plus)
    a = torch.clamp(torch.where(cond, a_plus, b_plus), 1e-5, 1e7)
    b = torch.clamp(torch.where(cond, b_plus, a_plus), 1e-5, 1e7)
    mean = a / (a + b)
    var = a * b / ((a + b) ** 2 * (a + b + 1.0))
    c = torch.sqrt(t21 * I / var)
    return c * (rand.beta(gen, a, b) - mean)


def _draw_type3(gen, t21, t31, t41, I):
    t31s = torch.where(t31.abs() > 1e-12, t31, torch.full_like(t31, 1e-12))
    scale = t31s.abs() / (2.0 * t21)
    shape = torch.clamp(4.0 * t21**3 * I / (t31s * t31s), 1e-5, 1e7)
    sign = torch.where(t31 > 0, 1.0, -1.0)
    return sign * scale * (rand.gamma(gen, shape) - shape)


def _draw_type5(gen, t21, t31, t41, I):
    beta1, _ = _betas(t21, t31, 0.0, I)
    beta1 = torch.where(beta1 > 1e-12, beta1, torch.full_like(beta1, 1e-12))
    sqrt_t = torch.sqrt(4.0 + beta1)
    p_plus = 4.0 * (1.0 + 2.0 / beta1 + sqrt_t / beta1)
    p_minus = 4.0 * (1.0 + 2.0 / beta1 - sqrt_t / beta1)
    p = torch.clamp(torch.where(p_plus > 4.0, p_plus, p_minus), 3.0 + 1e-5, 1e7)
    sigma = torch.sqrt(t21 * I)
    g5 = sigma * (p - 2.0) * torch.sqrt(p - 3.0)
    a = p - 1.0
    mu = g5 / (a - 1.0)
    y = g5 / torch.clamp(rand.gamma(gen, a), min=_TINY)
    sign = torch.where(t31 >= 0, 1.0, -1.0)
    return sign * (y - mu)


def _draw_type6(gen, t21, t31, t41, I):
    beta1, beta2 = _betas(t21, t31, t41, I)
    sign = torch.where(t31 >= 0, 1.0, -1.0)
    r = 6.0 * (beta2 - beta1 - 1.0) / (3.0 * beta1 - 2.0 * beta2 + 6.0)
    eps = r * r / (4.0 + (beta1 / 4.0) * (r + 2.0) ** 2 / (r + 1.0))
    d = torch.sqrt(torch.clamp(r * r - 4.0 * eps, min=0.0))
    q1 = (2.0 - r + d) / 2.0
    q2 = (r - 2.0 + d) / 2.0
    alpha = torch.clamp(q2 + 1.0, 1e-5, 1e7)
    beta = torch.clamp(q1 - q2 - 1.0, 2.0 + 1e-4, 1e7)
    var1 = alpha * (alpha + beta - 1.0) / ((beta - 2.0) * (beta - 1.0) ** 2)
    scale = torch.sqrt(t21 * I / var1)
    shift = scale * alpha / (beta - 1.0)
    ga = rand.gamma(gen, alpha)
    y = ga / torch.clamp(rand.gamma(gen, beta), min=_TINY)
    return sign * (scale * y - shift)


# -- Type 4 -------------------------------------------------------------------

def _type4_params(t21, t31, t41, I):
    """(m, nu, a, lam, valid); lanes with an inadmissible solution get
    safe placeholders."""
    beta1, beta2 = _betas(t21, t31, t41, I)
    mu2 = t21 * I
    denom = 2.0 * beta2 - 3.0 * beta1 - 6.0
    r = 6.0 * (beta2 - beta1 - 1.0) / torch.where(
        denom.abs() > 1e-20, denom, torch.full_like(denom, 1e-20))
    inner = 16.0 * (r - 1.0) - beta1 * (r - 2.0) ** 2
    valid = (r > 1.0) & (inner > 0.0)
    r = torch.where(valid, r, torch.full_like(r, 4.0))
    inner = torch.where(valid, inner, torch.full_like(inner, 16.0))
    sign = torch.where(t31 >= 0, -1.0, 1.0)  # sign(mu3) = -sign(nu)
    nu = sign * r * (r - 2.0) * torch.sqrt(beta1) / torch.sqrt(inner)
    a = torch.sqrt(mu2 * inner) / 4.0
    m = r / 2.0 + 1.0
    lam = a * nu / (2.0 * (m - 1.0))
    return m, nu, a, lam, valid


def _devroye_consts(m, nu, a):
    b = 2.0 * m - 2.0
    M = torch.atan2(-nu, b)
    cosM = b / torch.hypot(b, nu)
    r_const = b * torch.log(cosM) - nu * M
    rc = torch.exp(-r_const - _log_k(m, nu, a))
    acc = (math.pi / (4.0 * rc)) * torch.sqrt(
        2.0 / (math.pi * (2.0 * m + nu * nu / (2.0 * m))))
    return b, M, r_const, rc, acc


def _rej_rounds(gen, m, nu, a, lam, max_rounds):
    """Batched type-4 rejection on one chunk of lanes, all pending at
    the start.  Returns (draws, accepted): lanes still pending after
    ``max_rounds`` keep ``accepted`` False."""
    global rounds
    b, M, r_const, rc, acc = _devroye_consts(m, nu, a)

    # mixture-proposal constants (reference pt4_rvs_ar)
    theta = nu / (2.0 * m)
    root = torch.sqrt(1.0 + theta * theta)
    logk = _log_k(m, nu, a)
    log_dxds = torch.log(a) + 0.5 * torch.log1p(theta * theta)
    alpha = 2.0 * m - 1.0
    # log(0.5) + betaln(0.5, m - 0.5)
    log_P_left = (math.log(0.5) + math.lgamma(0.5) + torch.lgamma(m - 0.5)
                  - torch.lgamma(m))
    P = torch.clamp(torch.special.gammainc(alpha, 2.0 * m), 1e-30, 1.0)
    log_P_right_full = (
        2.0 * m - (2.0 * m - 1.0) * torch.log(2.0 * m) + torch.lgamma(alpha))
    log_P_right = log_P_right_full + torch.log(P)
    log_g0 = -torch.logaddexp(log_P_left, log_P_right)
    # Branch-pick probability uses the UNtruncated right-branch mass:
    # the right proposal is drawn by rejection (untruncated inverse-
    # gamma, auto-failing Y <= 1) rather than the host's inverse-CDF
    # truncated draw, so right-branch values land P times less often
    # per pick; boosting the pick rate by 1/P restores the realized
    # proposal density to the envelope shape the accept test assumes.
    w_left = torch.exp(log_P_left - torch.logaddexp(log_P_left, log_P_right_full))

    def log_fS(s, c):
        xi = c["root"] * s - c["theta"]
        return (c["logk"] + c["log_dxds"] - c["m"] * torch.log1p(xi * xi)
                - c["nu"] * torch.atan(xi))

    c = dict(m=m, nu=nu, a=a, lam=lam, b=b, M=M, r_const=r_const, rc=rc,
             use_dev=acc >= ACC_AR_CUT, theta=theta, root=root, logk=logk,
             log_dxds=log_dxds, alpha=alpha, log_g0=log_g0, w_left=w_left,
             flip=nu > 0.0)
    c["logc"] = torch.clamp(log_fS(torch.zeros_like(m), c) - log_g0, min=0.0)
    c["lane"] = torch.arange(m.shape[0], device=m.device)
    out = torch.zeros_like(m)
    accepted = torch.zeros(m.shape, dtype=torch.bool, device=m.device)

    for _ in range(max_rounds):
        if c["lane"].numel() == 0:
            break
        rounds += 1
        n = c["lane"].shape[0]
        dev = m.device

        def uniform():
            return torch.rand((n,), generator=gen, device=dev)

        # --- Devroye proposal (Heinrich 2004 section 7) ---
        x = 4.0 * uniform()
        swap = x > 2.0
        x = torch.where(swap, x - 2.0, x)
        logb = x > 1.0
        z = torch.where(logb, torch.log(torch.where(logb, x - 1.0, 1.0)), 0.0)
        x = torch.where(logb, 1.0 - z, x)
        x = torch.where(swap, c["M"] + c["rc"] * x, c["M"] - c["rc"] * x)
        ok = x.abs() < math.pi / 2.0
        logu = torch.log(torch.clamp(uniform(), min=_TINY))
        xo = torch.where(ok, x, 0.0)
        crit = c["b"] * torch.log(torch.cos(xo).abs()) - c["nu"] * x - c["r_const"]
        acc_d = ok & (z + logu <= crit)
        val_d = c["a"] * torch.tan(xo) + c["lam"]

        # --- mixture accept-reject proposal ---
        left = uniform() < c["w_left"]
        df = 2.0 * c["m"] - 1.0
        s_left = -rand.student_t(gen, df).abs() / torch.sqrt(df)
        G = torch.clamp(rand.gamma(gen, c["alpha"]), min=_TINY)
        Y = 2.0 * c["m"] / G
        trunc_ok = Y > 1.0  # truncated inverse-gamma: reject Y <= 1
        s0 = torch.where(left, s_left, Y - 1.0)
        s = torch.where(c["flip"], -s0, s0)
        lf = log_fS(s, c)
        mm = c["m"]
        lg = c["log_g0"] + torch.where(
            s0 < 0.0,
            -mm * torch.log1p(s0 * s0),
            torch.where(
                s0 > 0.0,
                -2.0 * mm * torch.log1p(s0.abs()) + (2.0 * mm * s0) / (1.0 + s0.abs()),
                0.0,
            ),
        )
        log_alpha = lf - lg - c["logc"]
        logu2 = torch.log(torch.clamp(uniform(), min=_TINY))
        acc_a = (left | trunc_ok) & (logu2 < torch.clamp(log_alpha, max=0.0))
        val_a = c["a"] * (c["root"] * s - c["theta"]) + c["lam"]

        accept = torch.where(c["use_dev"], acc_d, acc_a)
        val = torch.where(c["use_dev"], val_d, val_a)
        out[c["lane"]] = torch.where(accept, val, out[c["lane"]])
        accepted[c["lane"]] = accept
        keep = (~accept).nonzero().squeeze(1)
        c = {k: v.index_select(0, keep) for k, v in c.items()}
    return out, accepted


def _cf_draw(gen, mu2, g1, g2):
    """Cornish-Fisher polynomial-of-normal draw matching (mu2, gamma1,
    gamma2) to O(gamma^2), with the variance renormalized exactly."""
    z = torch.randn(mu2.shape, generator=gen, device=mu2.device)
    bq = g1 / 6.0
    al = g2 / 24.0 + 2.0 * (-g1 * g1 / 36.0)
    be = 3.0 * (g2 / 24.0) + 5.0 * (-g1 * g1 / 36.0)
    h = (1.0 - be) * z + bq * (z * z - 1.0) + al * z * z * z
    var_h = (1.0 - be) ** 2 + 2.0 * bq * bq + 15.0 * al * al + 6.0 * al * (1.0 - be)
    return torch.sqrt(mu2 / torch.clamp(var_h, min=1e-12)) * h


def _draw_type4(gen, t21, t31, t41, I, rej_buf, max_rounds):
    m, nu, a4, lam, valid = _type4_params(t21, t31, t41, I)
    mu2 = t21 * I
    beta1, beta2 = _betas(t21, t31, t41, I)
    g1 = torch.sign(t31) * torch.sqrt(torch.clamp(beta1, min=0.0))
    out = _cf_draw(gen, torch.clamp(mu2, min=1e-12), g1, beta2 - 3.0)
    rej = (valid & (m <= M_CF_CUT)).nonzero().squeeze(1)
    for start in range(0, rej.numel(), rej_buf):
        lanes = rej[start : start + rej_buf]
        d, accepted = _rej_rounds(gen, m[lanes], nu[lanes], a4[lanes], lam[lanes],
                                  max_rounds)
        # stragglers keep their Cornish-Fisher draw
        out[lanes] = torch.where(accepted, d, out[lanes])
    return out


# -- dispatcher ---------------------------------------------------------------

def _lanes(x, shape, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev).broadcast_to(shape).reshape(-1)


def draw_from_pearson_torch(gen, tilnu_21, tilnu_31, tilnu_41, I_arr, *,
                            atol=0.0, rej_buf=REJ_BUF, max_rounds=768):
    """One zero-mean Pearson deviate per element of ``I_arr``, float32,
    on ``gen``'s device.

    ``tilnu_*`` broadcast against ``I_arr`` (numbers, arrays or tensors;
    the noise engine passes per-endslice maps so every endslice class
    draws in one call).  Elements outside the admissibility region draw
    0, as in the reference dispatcher (``draw_with_tilnus.py:46-126``).
    """
    dev = gen.device
    I = torch.clamp(torch.as_tensor(I_arr, dtype=torch.float32, device=dev), min=0.01)
    shape = I.shape
    I = I.reshape(-1)
    t21, t31, t41 = (_lanes(t, shape, dev) for t in (tilnu_21, tilnu_31, tilnu_41))

    beta1, beta2 = _betas(t21, t31, t41, I)
    base = (beta2 > 0) & (beta1 >= 0) & (beta2 > beta1 + 1) & (beta2 > 0.75 * beta1)
    rhs1 = 1.5 * beta1 + 3.0
    rhs2 = (48.0 + 39.0 * beta1 + 6.0 * (4.0 + beta1) ** 1.5) / (32.0 - beta1)
    eq1 = (beta2 - rhs1).abs() <= atol
    eq2 = (beta2 - rhs2).abs() <= atol
    types = (
        (base & (beta2 < rhs1 - atol) & ~eq1, _draw_type1),
        (base & eq1, _draw_type3),
        (base & eq2, _draw_type5),
        (base & (beta2 > rhs1 + atol) & (beta2 < rhs2 - atol) & ~eq1 & ~eq2,
         _draw_type6),
        (base & (beta2 > rhs2 + atol) & (beta1 < 32.0) & ~eq2,
         lambda g, *p: _draw_type4(g, *p, rej_buf, max_rounds)),
    )
    out = torch.zeros_like(I)
    for mask, draw in types:
        lanes = mask.nonzero().squeeze(1)
        if lanes.numel():
            out[lanes] = draw(gen, t21[lanes], t31[lanes], t41[lanes], I[lanes])
    return out.reshape(shape)
