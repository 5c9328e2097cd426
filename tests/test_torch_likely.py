"""The port's likelihood ramp fitter against the JAX package's.

Same numpy inputs (from seeds) through ``ops/likely`` of both packages:

- ``build_likely_plan``: host float64 math copied, so every plan array
  is equal exactly;
- ``ramp_fit_likely``: group and pixel DQ equal except JUMP_DET /
  DO_NOT_USE on at most 1e-3 of the pixels, and slope, both errors,
  ``dumo`` and ``chisq`` within rtol 1e-5 + atol 1e-5 max|ref| on at
  least 99.9% of the pixels.  The share allows for pixels within an ulp
  of a u-bin edge (``round(log u)`` onto 12 bins) or of the rejection
  threshold: they take the neighbouring weights or flag, which moves the
  slope by far more than float tolerance.  Measured here: no DQ
  difference and no pixel outside the tolerance on these seeds;
- ``gls_chisq``: against the JAX function (rtol 1e-5) and against a
  dense float64 numpy GLS oracle (1e-3, the reference's own gate);
- the two-sided jump and early-jump DO_NOT_USE cases of the reference's
  tests, run on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romanimpreprocess_tpu.ops import likely as jlikely
from romanimpreprocess_tpu.ops import ramp as jramp
from romanimpreprocess_tpu_torch.dqflags import pixel
from romanimpreprocess_tpu_torch.ops import likely, ramp

torch.set_num_threads(1)

READ_PATTERN = [[0], [1, 2], [3, 4, 5], [6, 7, 8, 9, 10], [11, 12], [13]]
DT = 3.04
T = torch.from_numpy
OUT_NAMES = ("slope", "err_read", "err_poisson", "rdq", "pdq", "dumo", "chisq")


def _dq(u32):
    return T(np.ascontiguousarray(u32, np.uint32).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


PLAN_CASES = {
    "exclude_first": (True, {}),
    "keep_first": (False, {"rejection_threshold": 5.0}),
    "jump_kw": (True, {"rejection_threshold": 1e4, "nu": 7, "u_min": 1e-3,
                       "u_max": 10.0}),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_build_likely_plan_equals_reference(name):
    exclude_first, kw = PLAN_CASES[name]
    want = jlikely.build_likely_plan(jramp.ma_table_meta(READ_PATTERN, DT),
                                     exclude_first, **kw)
    got = likely.build_likely_plan(ramp.ma_table_meta(READ_PATTERN, DT),
                                   exclude_first, **kw)
    assert got._fields == want._fields
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f
    assert got.W.dtype == np.float32 and got.W.shape[0] == kw.get("nu", 12)


def _make_case(seed, ny=64, nx=64, nb=4):
    """Seeded ramps: positive and negative jumps, saturation starting in
    every group, a reference-pixel border and some flagged pixels."""
    rng = np.random.RandomState(seed)
    meta = ramp.ma_table_meta(READ_PATTERN, DT)
    ngrp = meta["ngrp"]
    tbar = meta["tbar"][:, None, None]
    gain = rng.uniform(1.4, 1.6, (ny, nx)).astype(np.float32)
    read_sigma = rng.uniform(5, 8, (ny, nx)).astype(np.float32)
    rate = 10.0 ** rng.uniform(-1, 2.3, (ny, nx))
    data = rate[None] * tbar
    data += rng.normal(0, 6, data.shape) / np.sqrt(meta["N"])[:, None, None]
    data += rng.normal(0, np.sqrt(np.maximum(rate[None] * tbar / 1.5, 0)))
    for sign, n in ((+1, 40), (-1, 25)):
        jy, jx = rng.randint(nb, ny - nb, n), rng.randint(nb, nx - nb, n)
        for y, x, g in zip(jy, jx, rng.randint(1, ngrp, n)):
            data[g:, y, x] += sign * rng.uniform(300.0, 4000.0)
    rdq = np.zeros((ngrp, ny, nx), np.uint32)
    rdq[0] |= 1  # exclude_first DNU
    sy, sx = rng.randint(0, ny, 60), rng.randint(0, nx, 60)
    for k, (y, x) in enumerate(zip(sy, sx)):
        rdq[k % ngrp:, y, x] |= np.uint32(pixel.SATURATED)
    pdq = np.zeros((ny, nx), np.uint32)
    pdq[rng.rand(ny, nx) < 0.02] |= np.uint32(pixel.DEAD)
    border = np.ones((ny, nx), bool)
    border[nb:-nb, nb:-nb] = False
    pdq[border] |= np.uint32(pixel.REFERENCE_PIXEL)
    return meta, data.astype(np.float32), rdq, pdq, gain, read_sigma


def _both(meta, data, rdq, pdq, gain, read_sigma, exclude_first, nborder, **kw):
    jplan = jlikely.build_likely_plan(jramp.ma_table_meta(READ_PATTERN, DT),
                                      exclude_first, **kw)
    want = jlikely.ramp_fit_likely(
        jnp.asarray(data), jnp.asarray(rdq), jnp.asarray(pdq), jplan,
        jnp.asarray(gain), jnp.asarray(read_sigma), nborder=nborder)
    plan = likely.build_likely_plan(meta, exclude_first, **kw)
    got = likely.ramp_fit_likely(T(data), _dq(rdq), _dq(pdq), plan, T(gain),
                                 T(read_sigma), nborder=nborder)
    want = dict(zip(OUT_NAMES, (np.asarray(w) for w in want)))
    got = dict(zip(OUT_NAMES, got))
    for k in ("rdq", "pdq"):
        got[k] = _u32(got[k])
    return want, {k: np.asarray(v) for k, v in got.items()}


FIT_CASES = {
    "seed0": (0, True, 4, {"rejection_threshold": 5.0}),
    "seed1_keep_first": (1, False, 4, {}),
    "seed2_nborder0": (2, True, 0, {"rejection_threshold": 4.0}),
}


@pytest.fixture(scope="module")
def fits():
    out = {}
    for name, (seed, exclude_first, nborder, kw) in FIT_CASES.items():
        meta, data, rdq, pdq, gain, rs = _make_case(seed)
        if not exclude_first:
            rdq[0] &= ~np.uint32(1)
        out[name] = _both(meta, data, rdq, pdq, gain, rs, exclude_first,
                          nborder, **kw)
    return out


@pytest.mark.parametrize("name", list(FIT_CASES))
def test_ramp_fit_likely_dq_matches_reference(fits, name):
    want, got = fits[name]
    loose = np.uint32(pixel.JUMP_DET | pixel.DO_NOT_USE)
    for k in ("rdq", "pdq"):
        assert got[k].dtype == np.uint32 and got[k].shape == want[k].shape
        diff = got[k] ^ want[k]
        assert not (diff & ~loose).any(), k
    pix = ((got["pdq"] ^ want["pdq"]) != 0) | ((got["rdq"] ^ want["rdq"]) != 0).any(axis=0)
    assert pix.mean() <= 1e-3
    # the case exercises what it claims
    assert (want["pdq"] & pixel.JUMP_DET).astype(bool).sum() > 30
    assert (want["pdq"] & pixel.SATURATED).astype(bool).sum() > 30
    assert (want["pdq"] & pixel.DO_NOT_USE).astype(bool).sum() > 5


@pytest.mark.parametrize("name", list(FIT_CASES))
@pytest.mark.parametrize("key", ["slope", "err_read", "err_poisson", "dumo", "chisq"])
def test_ramp_fit_likely_maps_match_reference(fits, name, key):
    want, got = fits[name]
    w, g = want[key], got[key]
    assert g.dtype == np.float32 and g.shape == w.shape
    assert np.isfinite(g).all()
    ok = np.abs(g - w) <= 1e-5 * np.abs(w) + 1e-5 * np.abs(w).max()
    assert ok.mean() >= 0.999, (key, 1 - ok.mean(), np.abs(g - w).max())


def _chisq_oracle(data_px, meta, start, m_eff, dvardt, s2):
    """Dense numpy GLS chi-square (Brandt 2024, eqs. 11-14): the full
    tridiagonal difference covariance, solved with np.linalg.inv."""
    tbar = meta["tbar"].astype(np.float64)
    tau = meta["tau"].astype(np.float64)
    N = meta["N"].astype(np.float64)
    delta = np.diff(data_px.astype(np.float64))
    dt = np.diff(tbar)
    idx = [i for i in range(len(delta)) if start <= i <= m_eff - 2]
    if len(idx) < 2:
        return 0.0
    n = len(idx)
    C = np.zeros((n, n))
    for a, i in enumerate(idx):
        C[a, a] = (tau[i] + tau[i + 1] - 2 * tbar[i]) * dvardt + (
            1 / N[i] + 1 / N[i + 1]) * s2
        if a + 1 < n and idx[a + 1] == i + 1:
            C[a, a + 1] = C[a + 1, a] = (
                (tbar[i + 1] - tau[i + 1]) * dvardt - s2 / N[i + 1])
    Ci = np.linalg.inv(C)
    d, t = delta[idx], dt[idx]
    return (d @ Ci @ d - (t @ Ci @ d) ** 2 / (t @ Ci @ t)) / (n - 1)


@pytest.mark.parametrize("exclude_first", [True, False])
def test_gls_chisq_matches_reference_and_dense_oracle(exclude_first):
    rng = np.random.RandomState(11)
    meta = ramp.ma_table_meta(READ_PATTERN, DT)
    ngrp = meta["ngrp"]
    ny = nx = 8
    data = rng.uniform(100, 4000, (ngrp, ny, nx)).astype(np.float32)
    data += np.cumsum(rng.uniform(0, 500, (ngrp, ny, nx)), axis=0).astype(np.float32)
    dvardt = rng.uniform(1.0, 50.0, (ny, nx)).astype(np.float32)
    sig2 = rng.uniform(20.0, 60.0, (ny, nx)).astype(np.float32)
    m_eff = rng.randint(2, ngrp + 1, (ny, nx)).astype(np.int32)
    plan = likely.build_likely_plan(meta, exclude_first)
    got = likely.gls_chisq(T(data), plan, T(m_eff), T(dvardt), T(sig2)).numpy()
    jplan = jlikely.build_likely_plan(jramp.ma_table_meta(READ_PATTERN, DT),
                                      exclude_first)
    want = np.asarray(jlikely.gls_chisq(jnp.asarray(data), jplan, jnp.asarray(m_eff),
                                        jnp.asarray(dvardt), jnp.asarray(sig2)))
    # the same Thomas steps; sums over the differences in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    for y in range(ny):
        for x in range(nx):
            oracle = _chisq_oracle(data[:, y, x], meta, plan.start, int(m_eff[y, x]),
                                   float(dvardt[y, x]), float(sig2[y, x]))
            assert abs(got[y, x] - oracle) <= 1e-3 * max(1.0, abs(oracle)), (y, x)


def test_gls_chisq_clean_ramp_reads_one_per_dof():
    rng = np.random.RandomState(4)
    meta = ramp.ma_table_meta(READ_PATTERN, DT)
    ngrp = meta["ngrp"]
    ny = nx = 96
    g, sig_dn, rate_dn = 1.6, 6.0, 30.0
    nreads = max(max(grp) for grp in READ_PATTERN) + 1
    e = rng.poisson(rate_dn * g * DT, (nreads, ny, nx)).astype(np.float64)
    reads = np.cumsum(e, axis=0) / g + rng.normal(0, sig_dn, (nreads, ny, nx))
    data = np.stack([reads[grp].mean(axis=0) for grp in READ_PATTERN])
    plan = likely.build_likely_plan(meta, True)
    chisq = likely.gls_chisq(
        T(data.astype(np.float32)), plan, torch.full((ny, nx), ngrp, dtype=torch.int32),
        torch.full((ny, nx), rate_dn / g), torch.full((ny, nx), sig_dn**2)).numpy()
    assert abs(chisq.mean() - 1.0) < 0.05, chisq.mean()
    assert 0.5 < np.median(chisq) < 1.0


def test_two_sided_jump_is_flagged_and_refit():
    rp = [[0], [1], [2], [3], [4], [5], [6], [7]]
    meta = ramp.ma_table_meta(rp, 3.04)
    plan = likely.build_likely_plan(meta, exclude_first=False,
                                    rejection_threshold=4.5)
    ny = nx = 16
    ngrp = len(rp)
    rng = np.random.default_rng(3)
    data = 5.0 * meta["tbar"][:, None, None] + rng.normal(0, 0.5, (ngrp, ny, nx))
    data[5:, 8, 8] -= 200.0  # a NEGATIVE step between groups 4 and 5
    out = likely.ramp_fit_likely(
        T(data.astype(np.float32)), torch.zeros((ngrp, ny, nx), dtype=torch.int32),
        torch.zeros((ny, nx), dtype=torch.int32), plan,
        torch.full((ny, nx), 1.5), torch.full((ny, nx), 0.5), nborder=1)
    assert (_u32(out[3])[:, 8, 8] & pixel.JUMP_DET).any()
    assert abs(out[0][8, 8].item() - 5.0) < 0.5  # refit on the clean prefix


def test_early_jump_flags_do_not_use_and_late_jump_keeps_chisq():
    meta, data, rdq, pdq, gain, rs = _make_case(0)
    ngrp = meta["ngrp"]
    rdq[:] = 0
    rdq[0] |= 1
    pdq[:] = 0
    tb = meta["tbar"].astype(np.float32)
    data[:, 20, 20] = 5.0 * tb
    data[2:, 20, 20] += 30000.0  # clean prefix of 2 groups: no refit variant
    data[:, 30, 30] = 5.0 * tb
    data[ngrp - 1:, 30, 30] += 30000.0  # jump at the last group
    plan = likely.build_likely_plan(meta, True, rejection_threshold=5.0)
    out = likely.ramp_fit_likely(T(data), _dq(rdq), _dq(pdq), plan, T(gain),
                                 T(rs), nborder=1)
    p = int(_u32(out[4])[20, 20])
    assert p & pixel.JUMP_DET and p & pixel.DO_NOT_USE
    p = int(_u32(out[4])[30, 30])
    assert p & pixel.JUMP_DET and not p & pixel.DO_NOT_USE
    assert abs(out[0][30, 30].item() - 5.0) < 2.0
    assert out[6][30, 30].item() < 30.0
