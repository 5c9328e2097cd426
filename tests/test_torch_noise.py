"""The port's noise engine against the JAX package's, on the CPU.

The 128^2 fixtures of ``tests/test_noise.py`` and
``tests/test_noise_core.py`` (the same read pattern, seeds and layers):
the JAX package simulates and calibrates the exposure and draws its
noise cube; the port calibrates the same L1 and draws its own.  The
deterministic parts are held exactly (weight vectors, tilde-nus) or to
float tolerance (the 'P...r' resample on injected increments, the
bisection quantiles); the random layers, whose streams differ, to the
reference's spread gates.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from romanimpreprocess_tpu.ops import sky as jsky
from romanimpreprocess_tpu.pipeline import l1_to_l2 as jl12
from romanimpreprocess_tpu.pipeline import noise as jnoise
from romanimpreprocess_tpu.pipeline import noise_core as jnoise_core
from romanimpreprocess_tpu.pipeline import sim_to_l1 as jsim
from romanimpreprocess_tpu.synth import make_cal_files, make_scene_file
from romanimpreprocess_tpu_torch import synth
from romanimpreprocess_tpu_torch.config import pattern_to_reads
from romanimpreprocess_tpu_torch.galpoisson import get_tilde_nus
from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles
from romanimpreprocess_tpu_torch.ops import sky
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, noise, noise_core, sim_to_l1

torch.set_num_threads(1)

READ_PATTERN = [[0], [1, 2], [3, 4, 5], [6, 7, 8, 9, 10], [11, 12], [13]]
N = 128
NA = N - 8
FT = 3.04
LAYERS = ["Rz4S2C1", "O", "Prb2"]  # tests/test_noise.py
LAYERS_CORE = ["Rz4S2", "O", "PbrS2"]  # tests/test_noise_core.py


def _spread(x):
    return np.percentile(x, 95) - np.percentile(x, 5)


def _exposure(d, sim_seed, layers, noise_seed):
    """One 128^2 exposure simulated and calibrated by the JAX package,
    its JAX noise cube (the default device engine), and the port's L2
    and noise cube (``device-strict``) of the same L1."""
    scene = make_scene_file(d + "/truth_F184_163_4.fits", nside_active=NA, nstars=5)
    caldir = make_cal_files(d + "/roman_wfi", READ_PATTERN, nside=N, seed=5)
    jsim.run_config({"IN": scene, "OUT": d + "/L1.asdf",
                     "READS": pattern_to_reads(READ_PATTERN), "CALDIR": caldir,
                     "SEED": sim_seed})
    jcfg = {"IN": d + "/L1.asdf", "OUT": d + "/L2_jax.asdf",
            "FITSWCS": d + "/L1_asdf_wcshead.txt", "CALDIR": caldir,
            "SKYORDER": 2, "SLICEOUT": True,
            "NOISE": {"LAYER": layers, "SEED": noise_seed,
                      "OUT": d + "/L2_noise_jax.asdf"}}
    jl12.calibrateimage(jcfg)
    jcube = np.asarray(jnoise.make_noise_cube(jcfg))
    cfg = dict(jcfg, OUT=d + "/L2.asdf")
    cfg["NOISE"] = dict(jcfg["NOISE"], BACKEND="device-strict",
                        OUT=d + "/L2_noise.asdf")
    l1_to_l2.calibrateimage(cfg, device="cpu")
    noise.generate_all_noise(cfg, device="cpu")
    cube = np.asarray(asdf_lite.open(cfg["NOISE"]["OUT"])["noise"])
    l2 = asdf_lite.open(jcfg["OUT"])["roman"]
    return dict(d=d, cfg=cfg, jcube=jcube, cube=cube,
                good=np.asarray(l2["dq"]) == 0,
                sig=np.asarray(l2["data_withsky"]),
                l2=asdf_lite.open(cfg["OUT"]))


@pytest.fixture(scope="module")
def exposure(tmp_path_factory):
    return _exposure(str(tmp_path_factory.mktemp("tnz")), 200, LAYERS, 10000)


@pytest.fixture(scope="module")
def exposure_core(tmp_path_factory):
    return _exposure(str(tmp_path_factory.mktemp("tnc")), 300, LAYERS_CORE, 77)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A port CALDIR and synthetic L1 at 128^2 and 64^2: (prep, pack,
    arrs) for the exposure runner, the rate 3 e/s with one bright spot."""
    d = str(tmp_path_factory.mktemp("tnb"))
    out = {}
    for n in (N, 64):
        caldir = synth.make_cal_files(d + f"/cal{n}", READ_PATTERN, nside=n, seed=5)
        cal = synth.synth_cal_arrays(n, READ_PATTERN, seed=5)
        synth.write_l1_file(d + f"/L1_{n}.asdf",
                            synth.synth_l1_cube(cal, READ_PATTERN, rate_dn_s=3.0,
                                                nborder=4),
                            READ_PATTERN, amp33=synth.synth_amp33(n, len(READ_PATTERN), 4))
        pack = calfiles.load_caldir_cached(caldir)
        l1 = asdf_lite.open(d + f"/L1_{n}.asdf")["roman"]
        prep = l1_to_l2.prepare_inputs(l1, {"CALDIR": caldir, "SKYORDER": 2}, pack,
                                       device="cpu")
        rate = np.full((n - 8, n - 8), 3.0, np.float32)
        rate[10:14, 10:14] = 300.0
        out[n] = (prep, pack, noise_core.exposure_arrays(prep, rate))
    return out


# --------------------------------------------------------------------------
# deterministic parts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("exclude_first", [True, False])
def test_weightvec_and_tilnus_tables_exact(exposure, exclude_first):
    pi = exposure["l2"]["processinfo"]
    tbar, w = pi["meta"]["tbar"], pi["weights"]
    got, start = noise.weightvec_table(tbar, w, 6, exclude_first)
    want, jstart = jnoise.weightvec_table(tbar, w, 6, exclude_first)
    assert start == jstart
    for g, wv in zip(got, want):
        assert (g is None) == (wv is None)
        if wv is not None:
            np.testing.assert_array_equal(g, wv)
            assert g.dtype == wv.dtype
    assert noise_core._tilnus_table(READ_PATTERN, got, start, FT) == \
        jnoise_core._tilnus_table(READ_PATTERN, want, jstart, FT)
    es_got = noise._weightvecs_and_endslice(pi, 6)[1]
    es_want = jnoise._weightvecs_and_endslice(pi, 6)[1]
    np.testing.assert_array_equal(es_got, es_want)


@pytest.mark.parametrize("contract", ["dot", "cuda"])
def test_resample_with_injected_increments_matches(exposure, monkeypatch, contract):
    """'P...r' with the JAX draw replaced by injected increments: the
    port's deterministic part (both contraction routes; on the CPU the
    kernel's route takes its plain twin) against JAX's."""
    pi = exposure["l2"]["processinfo"]
    wv, _ = noise.weightvec_table(pi["meta"]["tbar"], pi["weights"], 6, True)
    rng = np.random.default_rng(3)
    n = 48
    e = rng.uniform(0.5, 80.0, (n, n)).astype(np.float32)
    g = rng.uniform(1.5, 2.2, (n, n)).astype(np.float32)
    es = rng.integers(-1, 6, (n, n))
    es = np.where(es > 0, es, 5).astype(np.int32)
    incs = rng.poisson(e, (14, n, n)).astype(np.float32)
    monkeypatch.setattr(jnoise.rand, "poisson",
                        lambda key, lam, shape=None: jnp.asarray(incs))
    want = np.asarray(jnoise.resample_traced(
        jax.random.key(0), jnp.asarray(e), jnp.asarray(g), jnp.asarray(es),
        READ_PATTERN, wv, 6))
    got = noise.resample_increments(
        torch.from_numpy(incs), torch.from_numpy(e), torch.from_numpy(g),
        torch.from_numpy(es), READ_PATTERN, wv, 6, contract=contract).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_bisect_quantiles_matches():
    rng = np.random.default_rng(4)
    x = (rng.standard_t(3, (NA, NA)) * 0.7 + 0.1).astype(np.float32)
    qs = (0.25, 0.5, 0.75)
    got = sky.bisect_quantiles(torch.from_numpy(x), qs).numpy()
    want = np.asarray(jsky.bisect_quantiles(jnp.asarray(x), qs))
    tol = (x.max() - x.min()) * 2.0**-26
    assert np.abs(got - want).max() <= tol, (got, want)
    np.testing.assert_allclose(got, np.percentile(x, [25, 50, 75]), atol=1e-3)


# --------------------------------------------------------------------------
# the random layers: spread gates
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which,j", [("exposure", 0), ("exposure", 1), ("exposure", 2),
                                     ("exposure_core", 0), ("exposure_core", 1),
                                     ("exposure_core", 2)])
def test_layer_spreads_match_jax(request, which, j):
    e = request.getfixturevalue(which)
    good = e["good"]
    assert e["cube"].shape == e["jcube"].shape == (3, NA, NA)
    assert e["cube"].dtype == np.float32 and np.isfinite(e["cube"]).all()
    st, sj = _spread(e["cube"][j][good]), _spread(e["jcube"][j][good])
    assert 0.75 < st / sj < 1.33, (e["cfg"]["NOISE"]["LAYER"][j], st, sj)
    assert abs(np.median(e["cube"][j][good])) < 0.3


def test_layer_spreads_analytic(exposure):
    """The spreads against the analytic predictions of
    ``tests/test_run_all.py``: the R layer's white read noise through
    the weights (1/f banding adds on top), the O layer's tilnu21 * gain
    * signal, the P layer's the same at the sky level."""
    e = exposure
    pi = e["l2"]["processinfo"]
    W = np.asarray(pi["weights"], np.float64)
    nvec = np.array([len(g) for g in READ_PATTERN], np.float64)
    pack = calfiles.load_caldir(e["cfg"]["CALDIR"])
    act = np.s_[4:-4, 4:-4]
    good, cube = e["good"], e["cube"]
    sig_R = float(np.median(pack.read_sigma[act])) * np.sqrt(np.sum(W**2 / nvec))
    assert 0.8 < _spread(cube[0][good]) / 3.29 / sig_R < 2.0
    a_beta = np.array([g[0] for g in READ_PATTERN])
    N_beta = np.array([len(g) for g in READ_PATTERN])
    t21 = get_tilde_nus(N_beta, a_beta, W)[0] * FT
    gain_a = pack.gain[act]
    withsky = np.asarray(e["l2"]["roman"]["data_withsky"])
    sig_O = float(np.median((np.sqrt(t21 * np.clip(withsky, 0.01, None) * gain_a)
                             / gain_a)[good]))
    assert 0.7 < _spread(cube[1][good]) / 3.29 / sig_O < 1.4
    _, skylevel = sky.medfit(torch.from_numpy(withsky), order=2)
    sig_P = float(np.median((np.sqrt(t21 * np.clip(skylevel.numpy(), 0.01, None)
                                     * gain_a) / gain_a)[good]))
    assert 0.7 < _spread(cube[2][good]) / 3.29 / sig_P < 1.4


def test_o_layer_tracks_signal(exposure):
    x, good, sig = exposure["cube"][1], exposure["good"], exposure["sig"]
    hi = good & (sig > np.percentile(sig, 95))
    lo = good & (sig < np.percentile(sig, 50))
    assert x[hi].std() > 1.5 * x[lo].std()


def _cube(e, **nz):
    cfg = dict(e["cfg"])
    cfg["NOISE"] = dict(cfg["NOISE"], **nz)
    return noise.make_noise_cube(cfg, device="cpu")


def test_device_and_host_engines_agree(exposure):
    host = _cube(exposure, BACKEND="host")
    good = exposure["good"]
    for j in range(3):
        sd, sh = _spread(exposure["cube"][j][good]), _spread(host[j][good])
        assert 0.75 < sd / sh < 1.33, (j, sd, sh)
        assert abs(np.median(host[j][good])) < 0.3


def test_pearson_backends_agree(exposure):
    """The 'O' layer from the torch sampler and from the host sampler
    (``PEARSON_BACKEND: host``, which runs the layer-by-layer engine)."""
    good = exposure["good"]
    s = {b: _spread(_cube(exposure, LAYER=["O"], BACKEND="device",
                          PEARSON_BACKEND=b)[0][good])
         for b in ("jax", "Host")}
    assert 0.9 < s["jax"] / s["Host"] < 1.1, s


def test_deterministic_per_seed(exposure):
    a = _cube(exposure)
    np.testing.assert_array_equal(a, _cube(exposure))
    np.testing.assert_array_equal(a, exposure["cube"])
    assert not np.array_equal(a, _cube(exposure, SEED=10001))


def test_layer_streams_do_not_depend_on_other_layers(exposure):
    """A layer's draws come from its own (seed, layer, component)
    streams: the same command at the same index gives the same plane
    whatever the other layers are."""
    a = _cube(exposure, LAYER=["Rz4S2C1", "O"])
    b = _cube(exposure, LAYER=["Rz4S2C1", "O", "Prb2", "Rz4"])
    np.testing.assert_array_equal(a, b[:2])
    assert not np.array_equal(b[0], b[3])


def test_exposure_runner_layers_independent_beyond_six(bundle):
    """Eight identical 'R' commands (the reference production config
    runs 8 layers) give 8 pairwise-distinct planes."""
    prep, pack, arrs = bundle[N]
    cube, base, checksum = noise_core.make_staged_exposure_runner(
        prep, pack, ["Rz4"] * 8)(31, arrs)
    assert cube.shape == (8, NA, NA) and torch.isfinite(cube).all()
    assert float(checksum) == float(cube.sum())
    for i in range(8):
        for j in range(i + 1, 8):
            assert not torch.equal(cube[i], cube[j]), (i, j)


def test_exposure_runner_history_independent(bundle):
    """run(seed2) does not depend on which seeds ran before it: the dark
    reference reads the exposure's amp33, so it is computed per call."""
    prep, pack, arrs = bundle[64]
    run = noise_core.make_staged_exposure_runner(prep, pack, ["Rz4"])
    a = run(2, arrs)[0]
    run(1, arrs)
    np.testing.assert_array_equal(a.numpy(), run(2, arrs)[0].numpy())


def test_exposure_runner_layers_and_fused_names(bundle):
    """sim -> L1 -> L2 -> layers at 128^2: finite cube, sane spreads,
    the slope recovers the rate; the fused names give the same (cube,
    base) for the same seed."""
    prep, pack, arrs = bundle[N]
    cube, base, _ = noise_core.make_staged_exposure_runner(prep, pack, LAYERS_CORE)(9, arrs)
    good = base["pdq"][4:-4, 4:-4].numpy() == 0
    med = float(np.median(base["slope_withsky"][4:-4, 4:-4].numpy()[good]))
    assert 1.0 < med < 4.0, med  # 3 e/s through a gain near 1.8
    for j in range(3):
        assert 0.005 < _spread(cube[j].numpy()[good]) < 10.0
    fcube, fbase = noise_core.make_full_exposure_core(prep, pack, LAYERS_CORE)(9, arrs)
    assert torch.equal(fcube, cube) and torch.equal(fbase["slope"], base["slope"])
    ncube, _, _ = noise_core.make_staged_noise_runner(prep, pack, LAYERS_CORE)(9, prep["arr"])
    ecube, _ = noise_core.make_exposure_noise_core(prep, pack, LAYERS_CORE)(9, prep["arr"])
    assert torch.equal(ncube, ecube)


def test_ra_additive_layer(exposure):
    """'Ra' adds the noise to the science data and differences against
    the base L2 (no dark reference): the gates of
    ``tests/test_noise_layers.py``."""
    good = exposure["good"]
    for backend in ("device-strict", "host"):
        x = _cube(exposure, LAYER=["Raz3S1C0"], SEED=500, BACKEND=backend)[0]
        assert x.shape == (NA, NA)
        assert 0.2 < _spread(x[good]) < 3.0
        assert abs(np.median(x[good])) < 0.3


def test_noise_on_likelihood_path(tmp_path):
    """The device engine on the likelihood-fit plan
    (``tests/test_likely_workflow.py:156``)."""
    d = str(tmp_path)
    scene = synth.make_scene_file(d + "/truth_F184_163_4.fits", nside_active=NA, nstars=3)
    caldir = synth.make_cal_files(d + "/roman_wfi", READ_PATTERN, nside=N, seed=9)
    sim_to_l1.run_config({"IN": scene, "OUT": d + "/L1.asdf",
                          "READS": pattern_to_reads(READ_PATTERN), "CALDIR": caldir,
                          "SEED": 400}, device="cpu")
    c2 = {"IN": d + "/L1.asdf", "OUT": d + "/L2.asdf",
          "FITSWCS": d + "/L1_asdf_wcshead.txt", "CALDIR": caldir,
          "SKYORDER": 2, "SLICEOUT": True, "romancal_ramp_fit": True,
          "NOISE": {"LAYER": ["Rz4S2", "O"], "SEED": 77, "BACKEND": "device-strict",
                    "OUT": d + "/nz.asdf"}}
    l1_to_l2.calibrateimage(c2, device="cpu")
    noise.generate_all_noise(c2, device="cpu")
    nz = np.asarray(asdf_lite.open(d + "/nz.asdf")["noise"])
    assert nz.shape == (2, NA, NA)
    good = np.asarray(asdf_lite.open(d + "/L2.asdf")["roman"]["dq"]) == 0
    for j in range(2):
        x = nz[j][good]
        assert np.isfinite(x).all()
        assert abs(np.median(x)) < 0.3
        assert 0.05 < _spread(x) < 50.0


# --------------------------------------------------------------------------
# errors, the fallback and the entry points
# --------------------------------------------------------------------------

def test_strict_rejects_host_pearson(exposure):
    with pytest.raises(ValueError, match="device-strict"):
        _cube(exposure, BACKEND="device-strict", PEARSON_BACKEND="host")


def test_device_failure_falls_back_on_the_same_device(exposure, monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("runner broke")

    monkeypatch.setattr(noise_core, "make_staged_noise_runner", broken)
    cube = _cube(exposure, BACKEND="device")
    assert "falling back to the layer-by-layer engine on cpu" in capsys.readouterr().err
    np.testing.assert_array_equal(cube, _cube(exposure, BACKEND="host"))
    with pytest.raises(RuntimeError, match="runner broke"):
        _cube(exposure, BACKEND="device-strict")


def test_noise_requires_sliceout(exposure, tmp_path):
    c4 = dict(exposure["cfg"], OUT=str(tmp_path / "L2ns.asdf"), SLICEOUT=False)
    l1_to_l2.calibrateimage(c4, device="cpu")
    c4["NOISE"] = dict(c4["NOISE"], OUT=str(tmp_path / "n.asdf"))
    for backend in ("device-strict", "host"):
        c4["NOISE"]["BACKEND"] = backend
        with pytest.raises(ValueError, match="SLICEOUT"):
            noise.generate_all_noise(c4, device="cpu")


def test_noise_precision(exposure, tmp_path):
    c3 = dict(exposure["cfg"], NOISE_PRECISION=16)
    c3["NOISE"] = dict(c3["NOISE"], OUT=str(tmp_path / "n16.asdf"))
    noise.generate_all_noise(c3, device="cpu")
    a16 = np.asarray(asdf_lite.open(c3["NOISE"]["OUT"])["noise"])
    assert a16.dtype == np.float16
    a32 = exposure["cube"]
    assert np.all(np.abs((a16.astype(np.float32) - a32) / (1.0 + np.abs(a32))) < 0.005)
    c3["NOISE_PRECISION"] = -1
    with pytest.raises(ValueError, match="Unsupported noise precision."):
        noise.generate_all_noise(c3, device="cpu")


def test_main_writes_the_noise_file_and_needs_a_device(exposure, tmp_path):
    cfg = dict(exposure["cfg"], OUT=str(tmp_path / "L2.asdf"), SLICEOUT=False,
               FITSOUT=True)
    cfg["NOISE"] = dict(cfg["NOISE"], OUT=str(tmp_path / "nz.asdf"))
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    noise.main([str(path), "--device", "cpu"])
    assert "endslice" in asdf_lite.open(cfg["OUT"])["processinfo"]  # SLICEOUT forced
    np.testing.assert_array_equal(np.asarray(asdf_lite.open(cfg["NOISE"]["OUT"])["noise"]),
                                  exposure["cube"])
    assert (tmp_path / "nz_asdf_to.fits").exists()
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        noise.main([str(path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        noise.make_noise_cube(cfg)
