"""The port's detector characterization against the JAX package, on the CPU.

Flat ramps forward-modeled through the toy linearity curve of
``tests/test_characterize.py`` (the JAX package's inverse linearity,
64^2 pixels, ramps of 15 and 20 frames at 3.04 s), seeded with numpy,
fitted by both packages.  Tolerances, stated per test: the linearised
signal of the two fits at the JAX test's four fractions of the sampled
range within 1e-4 relative (median) and 1e-3 (largest); the domain
planes equal; the dq equal wherever |dg/dS| is clear of its threshold
(> 1e-5); the photon-transfer gain and the IPC alphas within rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romanimpreprocess_tpu.calib import characterize as jchar
from romanimpreprocess_tpu.io import asdf_lite as jasdf
from romanimpreprocess_tpu.ops import linearity as jlin
from romanimpreprocess_tpu_torch.calib import characterize
from romanimpreprocess_tpu_torch.io import asdf_lite

torch.set_num_threads(1)

N = 64
FRACS = (0.15, 0.4, 0.7, 0.95)  # tests/test_characterize.py


def _toy_linearity(rng):
    """tests/test_characterize.py:18-31."""
    Smin = np.full((N, N), 4000.0, np.float32)
    Smax = (56000 + 2000 * rng.uniform(size=(N, N))).astype(np.float32)
    Sref = (Smin + 1000).astype(np.float32)
    data = np.zeros((4, N, N), np.float32)
    data[2] = 100 + 80 * rng.uniform(size=(N, N))
    z = 2 * (Sref - Smin) / (Smax - Smin) - 1
    data[1] = (Smax - Smin) / 2.0 - 3 * data[2] * z
    data[0] = -data[1] * z - data[2] * (1.5 * z**2 - 0.5)
    return jlin.LinearityData(jnp.asarray(data), jnp.asarray(Smin), jnp.asarray(Smax),
                              jnp.asarray(Sref), jnp.zeros((N, N), jnp.uint32))


@pytest.fixture(scope="module")
def ramps():
    lin = _toy_linearity(np.random.RandomState(42))
    t_hi = np.arange(1, 16) * 3.04
    t_lo = np.arange(1, 21) * 3.04
    out = []
    for a, ts in zip((900.0, 200.0), (t_hi, t_lo)):
        out.append(np.stack([np.asarray(jlin.invert_linearity(
            jnp.full((N, N), a * t, jnp.float32), lin)[0]) for t in ts]).astype(np.float32))
    sref = np.asarray(jlin.invert_linearity(jnp.zeros((N, N)), lin)[0])
    return dict(lin=lin, ramps=out, ts=[t_hi, t_lo], sref=sref)


def _linearised(fit, S):
    pack = jlin.LinearityData(*(jnp.asarray(fit[k]) for k in ("data", "Smin", "Smax",
                                                               "Sref", "dq")))
    return np.asarray(jlin.apply_linearity(jnp.asarray(S), pack)[0])


@pytest.mark.parametrize("p_order,n_iter", [(5, 5), (6, 4)])
def test_fit_linearity_matches_jax(ramps, p_order, n_iter):
    r = ramps
    want = jchar.fit_linearity(r["ramps"], r["ts"], r["sref"], p_order=p_order,
                               n_iter=n_iter)
    got = characterize.fit_linearity(r["ramps"], r["ts"], r["sref"], p_order=p_order,
                                     n_iter=n_iter, device="cpu")
    assert got["data"].shape == (p_order + 1, N, N) and got["data"].dtype == np.float32
    for k in ("Smin", "Smax", "Sref", "dq"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype
    max_s = r["ramps"][0][-1]
    for frac in FRACS:
        S = (r["sref"] + frac * (max_s - r["sref"])).astype(np.float32)
        a, b = _linearised(want, S), _linearised(got, S)
        rel = np.abs(b - a) / np.maximum(np.abs(a), 100.0)
        assert np.median(rel) < 1e-4 and rel.max() < 1e-3, (frac, np.median(rel), rel.max())
        # and both recover the true curve at the JAX test's gate
        true = np.asarray(jlin.apply_linearity(jnp.asarray(S), r["lin"])[0])
        assert np.median(np.abs(b - true) / np.maximum(np.abs(true), 100.0)) < 0.03


def test_fit_linearity_row_slabs_are_exact(ramps, monkeypatch):
    """A fit over row slabs of any size is the one-slab fit bit for bit
    (every pixel is fitted on its own)."""
    r = ramps

    def fit(slab, ramp_list=r["ramps"], bias=r["sref"]):
        monkeypatch.setattr(characterize, "LINFIT_SLAB_PIXELS", slab)
        return characterize.fit_linearity(ramp_list, r["ts"], bias, device="cpu")

    whole = fit(N * N)
    for slab in (N, 5 * N, 37):
        part = fit(slab)
        for k in whole:
            np.testing.assert_array_equal(part[k], whole[k], err_msg=(slab, k))
    # tensors on the device are accepted as well as host arrays
    tens = fit(N * N, [torch.from_numpy(x) for x in r["ramps"]], torch.tensor(r["sref"]))
    np.testing.assert_array_equal(tens["data"], whole["data"])


def _falling_at_sref(ts, rates=(0.07519, 0.03008), C=0.0986):
    """Raw ramps of a response g(z) = 3 z^2 + z + C sampled on
    0 <= z <= 0.9 (rising there), with Sref at z = -0.9, where g falls:
    a well-posed fit whose dg/dS at Sref is negative (dq set).  Domain
    [0, 10000] DN."""
    out = []
    for a, t in zip(rates, ts):
        z = (-1.0 + np.sqrt(1.0 - 12.0 * (C - a * t))) / 6.0
        out.append(5000.0 * (z + 1.0))
    return np.concatenate(out).astype(np.float32)


def test_linfit_dq_and_dg_ds_match(ramps):
    """Both inverse iterations start from e_1: dg/dS agrees to rtol 1e-3
    and the dq is equal wherever |dg/dS| > 1e-5.  A third of the pixels
    respond as :func:`_falling_at_sref` (dq set in both).  Order 2, at
    which that response is exact: at higher orders the data leave its
    extrapolation to Sref undetermined."""
    r = ramps
    stacked = np.concatenate(r["ramps"]).astype(np.float32)
    smin = np.minimum(stacked.min(0), r["sref"]) - 500.0
    smax = stacked.max(0) / 0.93
    sref = r["sref"].copy()
    stacked[:, :, ::3] = _falling_at_sref(r["ts"])[:, None, None]
    smin[:, ::3], smax[:, ::3], sref[:, ::3] = 0.0, 10000.0, 500.0
    tvec = np.concatenate(r["ts"])
    rid = np.repeat([0, 1], [len(t) for t in r["ts"]])
    tw = np.stack([np.where(rid == j, tvec, 0.0) for j in (0, 1)]).astype(np.float32)
    t2 = np.array([np.sum(tvec[rid == j] ** 2) for j in (0, 1)], np.float32)
    _, dg_j = jchar._linfit_core(*(jnp.asarray(x) for x in (stacked, smin, smax, sref,
                                                             tw, t2)), p_order=2, n_iter=4)
    _, dg_t = characterize._linfit_core(
        torch.from_numpy(stacked.reshape(len(tvec), -1)),
        *(torch.from_numpy(x.ravel()) for x in (smin, smax, sref)),
        torch.from_numpy(tw), torch.from_numpy(t2), p_order=2, n_iter=4)
    dg_j, dg_t = np.asarray(dg_j).ravel(), dg_t.numpy()
    clear = np.abs(dg_j) > 1e-5
    assert clear.all()
    np.testing.assert_array_equal(dg_t <= 1e-6, dg_j <= 1e-6)
    assert (dg_j <= 1e-6).reshape(N, N)[:, ::3].all()
    assert not (dg_j <= 1e-6).reshape(N, N)[:, 1::3].any()
    np.testing.assert_allclose(dg_t, dg_j, rtol=1e-3)


def test_make_linearity_file_matches_jax(ramps, tmp_path):
    r = ramps
    pflat = np.random.default_rng(3).uniform(0.9, 1.1, (N, N)).astype(np.float32)
    a = characterize.make_linearity_file(str(tmp_path / "a.asdf"), 7, r["ramps"], r["ts"],
                                         r["sref"], p_order=5, n_iter=5, pflat=pflat,
                                         device="cpu")
    b = jchar.make_linearity_file(str(tmp_path / "b.asdf"), 7, r["ramps"], r["ts"],
                                  r["sref"], p_order=5, n_iter=5, pflat=pflat)
    ta, tb = asdf_lite.open(a)["roman"], jasdf.open(b)["roman"]
    assert set(ta) == set(tb)
    for k in ("dq", "Smin", "Smax", "Sref", "pflat", "dark", "ramperr"):
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    assert ta["meta"]["reftype"] == "LINEARITYLEGENDRE"
    assert ta["meta"]["author"] == "romanimpreprocess_tpu_torch.calib.characterize"
    S = (r["sref"] + 8000.0).astype(np.float32)
    fa = {k: np.asarray(ta[k]) for k in ("data", "Smin", "Smax", "Sref", "dq")}
    fb = {k: np.asarray(tb[k]) for k in ("data", "Smin", "Smax", "Sref", "dq")}
    x, y = _linearised(fb, S), _linearised(fa, S)
    assert np.median(np.abs(y - x) / np.maximum(np.abs(x), 100.0)) < 1e-4


@pytest.mark.parametrize("read_var,superpixel", [(0.0, 16), (3.5, 8)])
def test_gain_from_mean_variance_matches_jax(read_var, superpixel):
    rng = np.random.RandomState(5)
    cum = (np.cumsum(rng.poisson(2000.0, size=(30, N + 3, N)), axis=0) / 1.5).astype(
        np.float32)
    want = jchar.gain_from_mean_variance(cum, superpixel=superpixel, read_var=read_var)
    got = characterize.gain_from_mean_variance(cum, superpixel=superpixel,
                                               read_var=read_var, device="cpu")
    assert got.shape == want.shape == (N + 3, N) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert abs(np.median(got) - 1.5) / 1.5 < 0.1


def test_ipc_from_autocorr_matches_jax():
    rng = np.random.RandomState(6)
    cube = np.cumsum(rng.poisson(5000.0, size=(12, N, N)), axis=0).astype(np.float32)
    cube[:, :, 1:] += 0.01 * cube[:, :, :-1]
    want = jchar.ipc_from_autocorr(cube, nborder=2)
    got = characterize.ipc_from_autocorr(cube, nborder=2)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5)


@pytest.mark.parametrize("call", [
    lambda r: characterize.fit_linearity(r["ramps"], r["ts"], r["sref"]),
    lambda r: characterize.gain_from_mean_variance(r["ramps"][0]),
], ids=["fit_linearity", "gain_from_mean_variance"])
def test_entry_points_default_to_cuda(ramps, call):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(ramps)
