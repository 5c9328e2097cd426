"""The port's GalPoisson samplers against the JAX package's.

The numpy modules (``find_tilnus``, ``denoise_construct``, the host
sampler ``pearson``) are copies: equal outputs for one seed.  The torch
samplers (``ops/rand`` gamma / beta / Student-t, ``draw_from_pearson_torch``)
draw other random streams than ``jax.random``, so they are held to the
moment envelopes of ``tests/test_pearson_jax.py`` (the reference's
``test_pearson.py`` gates) and to the cross-backend variance agreement
against both the JAX device sampler and the host sampler.
"""

import numpy as np
import pytest
import scipy.special
import scipy.stats
import torch

import jax

from romanimpreprocess_tpu.galpoisson import denoise_construct as jdenoise
from romanimpreprocess_tpu.galpoisson import find_tilnus as jfind
from romanimpreprocess_tpu.galpoisson import pearson as jpearson
from romanimpreprocess_tpu.galpoisson.pearson import (
    _betas,
    _devroye_acc_rate,
    _type4_params,
)
from romanimpreprocess_tpu.galpoisson.pearson_jax import draw_from_pearson_jax
from romanimpreprocess_tpu_torch import galpoisson
from romanimpreprocess_tpu_torch.galpoisson import denoise_construct, pearson_torch
from romanimpreprocess_tpu_torch.ops import rand

torch.set_num_threads(1)

NSAMP = 100_000
READ_PATTERN = [[0], [1, 2], [3, 4, 5], [6, 7, 8, 9, 10], [11, 12], [13]]


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _draw(seed, t21, t31, t41, I, **kw):
    return pearson_torch.draw_from_pearson_torch(
        _gen(seed), t21, t31, t41, I, **kw).numpy().astype(np.float64)


def _check(draws, tilnu_21, tilnu_31, I, rtol=0.2):
    """The envelope of ``tests/test_pearson_jax.py``: variance, the sign
    of the third moment where it clears the MC noise, and the mean."""
    mu2_t = tilnu_21 * I
    mu2 = draws.var(ddof=0)
    assert abs(mu2 - mu2_t) / mu2_t < rtol, (mu2, mu2_t)
    mu3_t = tilnu_31 * I
    mc_noise = np.sqrt(15.0 / len(draws)) * mu2_t**1.5
    if abs(mu3_t) > 5 * mc_noise:
        mu3 = np.mean((draws - draws.mean()) ** 3)
        assert np.sign(mu3) == np.sign(tilnu_31)
    assert abs(draws.mean()) < 5 * np.sqrt(mu2_t / len(draws)) * 3


def _dominant_type(t21, t31, t41, I0):
    beta1, beta2 = _betas(t21, t31, t41, np.asarray([I0], float))
    rhs1 = 1.5 * beta1 + 3.0
    rhs2 = (48.0 + 39.0 * beta1 + 6.0 * (4.0 + beta1) ** 1.5) / (32.0 - beta1)
    if beta2 < rhs1:
        return 1
    if beta2 < rhs2:
        return 6
    return 4


# --------------------------------------------------------------------------
# the numpy copies
# --------------------------------------------------------------------------

def _weights(seed):
    w = np.random.default_rng(seed).normal(size=len(READ_PATTERN))
    w[0] = 0.0
    return w - w.mean()


@pytest.mark.parametrize("seed", [1, 2])
def test_tilde_nus_identical(seed):
    a_beta = np.array([g[0] for g in READ_PATTERN])
    N_beta = np.array([len(g) for g in READ_PATTERN])
    W = _weights(seed)
    np.testing.assert_array_equal(galpoisson.raw_weights(N_beta, a_beta),
                                  jfind.raw_weights(N_beta, a_beta))
    assert galpoisson.get_tilde_nus(N_beta, a_beta, W) == jfind.get_tilde_nus(
        N_beta, a_beta, W)
    assert denoise_construct.get_tilde_nus_from_list(READ_PATTERN, W) == \
        jdenoise.get_tilde_nus_from_list(READ_PATTERN, W)
    # the O(N^2) production algorithm and the O(N^4) oracle agree
    np.testing.assert_allclose(
        galpoisson.get_tilde_nus(N_beta, a_beta, W),
        denoise_construct.get_tilde_nus(N_beta, a_beta, W), rtol=1e-9)


def test_host_sampler_identical():
    """The host sampler, a copy: the same draws from one numpy seed over
    intensities that reach types 1, 6 and 4 (Devroye and mixture)."""
    I = np.geomspace(0.5, 500.0, 6000)
    for t in ((1.4375, -0.5, 0.15), (6.0, -1.0, 0.3), (1.0, -1.0, 10.0),
              (1.0, -1.089, 2.5)):
        got = galpoisson.draw_from_pearson(*t, I, rng=np.random.default_rng(5))
        want = jpearson.draw_from_pearson(*t, I, rng=np.random.default_rng(5))
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# special functions and samplers
# --------------------------------------------------------------------------

def test_lgamma_re_matches_scipy():
    rng = np.random.default_rng(0)
    x = rng.uniform(1.0, 300.0, 5000)
    y = rng.uniform(-200.0, 200.0, 5000)
    ref = scipy.special.loggamma(x + 1j * y).real
    got = pearson_torch._lgamma_re(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # float32, as the sampler runs it: 1e-5 of the largest magnitude
    got32 = pearson_torch._lgamma_re(torch.from_numpy(x.astype(np.float32)),
                                     torch.from_numpy(y.astype(np.float32))).numpy()
    assert np.abs(got32 - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("alpha", [0.3, 1.0, 7.5, 300.0])
def test_gamma_moments(alpha):
    n = 200_000
    x = rand.gamma(_gen(1), torch.full((n,), alpha)).double().numpy()
    assert x.dtype == np.float64 and (x >= 0).all()
    # Gamma(alpha, 1): mean = var = alpha
    assert abs(x.mean() - alpha) < 5 * np.sqrt(alpha / n)
    assert abs(x.var() / alpha - 1) < 5 * np.sqrt((2 + 6 / alpha) / n)


@pytest.mark.parametrize("a,b", [(0.5, 0.5), (2.0, 5.0), (40.0, 3.0)])
def test_beta_moments(a, b):
    n = 200_000
    x = rand.beta(_gen(2), torch.full((n,), a), torch.full((n,), b)).double().numpy()
    assert ((x >= 0) & (x <= 1)).all()
    mean = a / (a + b)
    var = a * b / ((a + b) ** 2 * (a + b + 1))
    assert abs(x.mean() - mean) < 5 * np.sqrt(var / n)
    assert abs(x.var() / var - 1) < 0.03


@pytest.mark.parametrize("df", [5.0, 30.0, 513.0])
def test_student_t_moments(df):
    n = 200_000
    x = rand.student_t(_gen(3), torch.full((n,), df)).double().numpy()
    var = df / (df - 2)
    assert abs(x.mean()) < 5 * np.sqrt(var / n)
    assert abs(x.var() / var - 1) < 0.05
    # the tails of a t: P(|T| > 3) against scipy
    want = 2 * scipy.stats.t.sf(3.0, df)
    assert abs((np.abs(x) > 3).mean() - want) < 5 * np.sqrt(want / n)


# --------------------------------------------------------------------------
# the torch Pearson sampler: the envelopes of test_pearson_jax.py
# --------------------------------------------------------------------------

def test_type1_moments_torch():
    t = (1.4375, -0.5, 0.15)
    assert _dominant_type(*t, 2.0) == 1
    _check(_draw(1, *t, np.full(NSAMP, 2.0)), t[0], t[1], 2.0)


def test_type6_moments_torch():
    t = (6.0, -1.0, 0.3)
    assert _dominant_type(*t, 3.5) == 6
    _check(_draw(6, *t, np.full(NSAMP, 3.5)), t[0], t[1], 3.5)


def test_type4_devroye_moments_torch():
    t = (1.0, -1.0, 10.0)
    assert _dominant_type(*t, 3.0) == 4
    I = np.full(NSAMP, 3.0)
    m, nu, a, lam = _type4_params(*t, I)
    assert np.all(_devroye_acc_rate(m, nu, a) > 0.02)  # Devroye route
    assert np.all(m < 256.0)  # exact-rejection regime (not CF)
    pearson_torch.rounds = 0
    _check(_draw(3, *t, I), t[0], t[1], 3.0)
    assert pearson_torch.rounds >= 1


def test_type4_ar_route_moments_torch():
    t = (1.0, -1.089, 2.5)
    I = np.full(20_000, 50.0)
    m, nu, a, lam = _type4_params(*t, I)
    assert np.all(m < 256.0)
    assert np.all(_devroye_acc_rate(m, nu, a) < 0.02)  # below ACC_AR_CUT
    _check(_draw(4, *t, I), t[0], t[1], 50.0)


def test_type4_cf_path_torch():
    t21, t31, t41 = 1.0, -0.05, 0.5
    I = np.full(NSAMP, 2000.0)
    m, nu, a, lam = _type4_params(t21, t31, t41, I)
    assert np.all(m > 256.0)  # CF regime
    pearson_torch.rounds = 0
    d = _draw(5, t21, t31, t41, I)
    assert pearson_torch.rounds == 0  # no rejection lane
    _check(d, t21, t31, 2000.0, rtol=0.05)
    mu4 = np.mean((d - d.mean()) ** 4)
    mu2_t = t21 * 2000.0
    beta2_t = (3 * t21**2 * 2000.0 + t41) / (t21**2 * 2000.0)
    assert abs(mu4 / mu2_t**2 - beta2_t) < 0.1


def test_compacted_buffer_path():
    """rej_buf below the lane count: the rejection runs chunk by chunk."""
    t = (1.0, -1.0, 10.0)
    n = 10_000
    pearson_torch.rounds = 0
    _draw(7, *t, np.full(n, 3.0))
    one_chunk = pearson_torch.rounds
    pearson_torch.rounds = 0
    d = _draw(7, *t, np.full(n, 3.0), rej_buf=1024)
    # ten chunks, each with its own rounds
    assert pearson_torch.rounds > one_chunk
    _check(d, t[0], t[1], 3.0, rtol=0.3)


def test_straggler_fallback_is_finite():
    """max_rounds=1 leaves most rejection lanes pending; the CF fallback
    keeps the draw finite and variance-sane."""
    t = (1.0, -1.0, 10.0)
    pearson_torch.rounds = 0
    d = _draw(8, *t, np.full(50_000, 3.0), max_rounds=1)
    assert pearson_torch.rounds == 1
    assert np.isfinite(d).all()
    _check(d, t[0], t[1], 3.0, rtol=0.3)


def test_dispatcher_mixed_intensities_torch():
    t = (1.4375, -0.5, 0.15)
    nrep, nI = 4000, 12
    I = np.geomspace(0.5, 500.0, nI)
    II = np.broadcast_to(I, (nrep, nI)).copy()
    d = _draw(9, *t, II)
    assert d.shape == (nrep, nI)
    var = d.var(axis=0, ddof=0)
    ok = np.abs(var / (t[0] * I) - 1) < 0.3
    assert ok.mean() > 0.9, (var, t[0] * I)


def test_inadmissible_draws_zero_and_reach_no_sampler(monkeypatch):
    """Inadmissible lanes (the noise engine's t41 = -1e12 filler among
    them) draw 0 and are never passed to a sampler."""
    seen = []
    real_gamma = rand.gamma

    def spy(gen, alpha):
        seen.append(alpha.numel())
        return real_gamma(gen, alpha)

    monkeypatch.setattr(pearson_torch.rand, "gamma", spy)
    assert (_draw(10, 1.0, 0.0, -10.0, np.full(10, 1e-6)) == 0).all()
    assert seen == []
    n = 1000
    t41 = np.where(np.arange(n) % 4 == 0, -1.0e12, 0.15)
    d = _draw(10, 1.4375, -0.5, t41, np.full(n, 2.0))
    assert (d[::4] == 0).all() and (d[1::4] != 0).all()
    # type 1 is a beta: two gammas over the admissible lanes only
    assert seen == [n - n // 4] * 2


def test_per_pixel_tilnu_maps():
    """Per-pixel tilnu maps (the multi-endslice 'O' layer): each class's
    variance tracks its own t21 * I."""
    n = 40_000
    even = np.arange(n) % 2 == 0
    t21 = np.where(even, 1.4375, 0.7)
    t31 = np.where(even, -0.5, -0.25)
    t41 = np.where(even, 0.15, 0.08)
    d = _draw(11, t21, t31, t41, np.full(n, 4.0))
    for sel, t in ((even, 1.4375), (~even, 0.7)):
        v = d[sel].var(ddof=0)
        assert abs(v - t * 4.0) / (t * 4.0) < 0.15, (v, t * 4.0)


def test_deterministic_per_generator_seed():
    t = (1.0, -1.0, 10.0)
    I = np.geomspace(0.5, 500.0, 3000)
    np.testing.assert_array_equal(_draw(12, *t, I), _draw(12, *t, I))
    assert not np.array_equal(_draw(12, *t, I), _draw(13, *t, I))


@pytest.mark.parametrize("t,I0", [
    ((1.4375, -0.5, 0.15), 2.0),   # type 1
    ((6.0, -1.0, 0.3), 3.5),       # type 6
    ((1.0, -1.0, 10.0), 3.0),      # type 4 (Devroye)
])
def test_cross_backend_variance_agreement(t, I0):
    """The torch sampler agrees on the 2nd moment, to MC noise, with the
    host sampler and with the JAX device sampler."""
    n = 60_000
    I = np.full(n, I0)
    d_host = galpoisson.draw_from_pearson(*t, I, rng=np.random.default_rng(42))
    d_jax = np.asarray(draw_from_pearson_jax(jax.random.key(12), *t, I), np.float64)
    d_torch = _draw(12, *t, I)
    vt = d_torch.var(ddof=0)
    for v in (d_host.var(ddof=0), d_jax.var(ddof=0)):
        assert abs(vt - v) / v < 0.1, (vt, v)
