"""The port's sim -> L1 slice against the JAX package.

torch cannot reproduce ``jax.random``, so the slice as a whole is held
statistically, at the JAX package's own gates (L1 format, slope
recovery, CR envelope and recall, determinism, ``NO_AMP33``, ``CNORM``,
the persistence hook: ``tests/test_workflow.py``, ``test_run_all.py``,
``test_sim_config_keys.py``) plus two cross checks: the port's L1 file
through the JAX ``calibrateimage`` recovers the port's ``truth_rate``,
and the resultants of the two ``make_l1_fullcal`` over 8 seeds on one
rate map agree in mean and variance within 4 sigma of their sampling
error.  Every deterministic piece is held on the same inputs: the
linearity inverse, ``IL.apply``, the contraction matrix, the
``EXTRACT_REF`` reshuffle, ``make_ideal_l2`` and ``pseudocalibrate`` to
rtol 1e-5 (float32 steps that XLA may fuse differently).

Frames are 128^2 or smaller, on the CPU (``device="cpu"``), where every
kernel wrapper takes its plain PyTorch version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romanimpreprocess_tpu.io import asdf_lite as jasdf
from romanimpreprocess_tpu.io import calfiles as jcalfiles
from romanimpreprocess_tpu.ops import linearity as jlinearity
from romanimpreprocess_tpu.ops import rand as jrand
from romanimpreprocess_tpu.pipeline import l1_to_l2 as jl1_to_l2
from romanimpreprocess_tpu.pipeline import sim_to_l1 as jsim
from romanimpreprocess_tpu.utils import skymodel as jskymodel
from romanimpreprocess_tpu_torch import pars, synth
from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles, fits_lite, staging
from romanimpreprocess_tpu_torch.ops import linearity, rand, wcsutils
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, sim_to_l1
from romanimpreprocess_tpu_torch.utils import skymodel

torch.set_num_threads(1)

READ_PATTERN = synth.READ_PATTERN_DEFAULT
N = 128
NA = N - 8
JUMP_DET = 4
SEED = 200


def _reads(read_pattern=READ_PATTERN):
    out = []
    for g in read_pattern:
        out += [g[0], g[-1] + 1]
    return out


def _close(got, want, rtol=1e-5):
    """rtol on each value plus atol = rtol * max|want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_sim"))
    scene = synth.make_scene_file(d + "/truth_F184_163_4.fits", nside_active=NA,
                                  nstars=5)
    caldir = synth.make_cal_files(d + "/roman_wfi", READ_PATTERN, nside=N, seed=5)
    c1 = {"IN": scene, "OUT": d + "/L1.asdf", "READS": _reads(),
          "CALDIR": caldir, "SEED": SEED, "FITSOUT": True}
    x = sim_to_l1.run_config(c1, device="cpu")
    c2 = {"IN": d + "/L1.asdf", "OUT": d + "/L2.asdf",
          "FITSWCS": d + "/L1_asdf_wcshead.txt", "CALDIR": caldir,
          "SKYORDER": 2, "SLICEOUT": True}
    l1_to_l2.calibrateimage(c2, device="cpu")
    jl1_to_l2.calibrateimage(dict(c2, OUT=d + "/L2_jax.asdf"))
    return d, scene, caldir, c1, c2, x


@pytest.fixture(scope="module")
def lin_case():
    """Linearity tensors of a 32^2 synthetic detector, numpy."""
    cal = synth.synth_cal_arrays(32, READ_PATTERN, seed=3)
    names = ("lin_coefs", "lin_smin", "lin_smax", "lin_sref", "lin_dq")
    return cal, [cal[k] for k in names]


def _port_lin(arrs):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs[:4]]
    return linearity.LinearityData(*t, torch.from_numpy(arrs[4].view(np.int32)))


def _jax_lin(arrs):
    return jlinearity.LinearityData(*(jnp.asarray(a) for a in arrs))


# --------------------------------------------------------------------------
# deterministic pieces, same inputs
# --------------------------------------------------------------------------

def test_invert_linearity_matches_reference(lin_case):
    cal, arrs = lin_case
    rng = np.random.RandomState(0)
    # linearized DN from below the range (saturates at z = -1) to above it
    slin = rng.uniform(-3000, 60000, (3, 32, 32)).astype(np.float32)
    want, ex_want = jlinearity.invert_linearity(jnp.asarray(slin), _jax_lin(arrs))
    got, ex_got = linearity.invert_linearity(torch.from_numpy(slin), _port_lin(arrs))
    _close(got.numpy(), want)
    assert np.array_equal(ex_got.numpy(), np.asarray(ex_want))
    # it inverts the forward expansion where the ramp is in range
    back, _ = linearity.apply_linearity_cube(got, _port_lin(arrs), False)
    mid = (slin > 2000) & (slin < 40000)
    assert np.abs(back.numpy() - slin)[mid].max() < 0.05


@pytest.mark.parametrize("ndim", [2, 3])
def test_il_apply_matches_reference(lin_case, ndim):
    cal, arrs = lin_case
    rng = np.random.RandomState(ndim)
    na = 24
    shape = (na, na) if ndim == 2 else (4, na, na)
    counts = rng.uniform(0, 60000, shape).astype(np.float32)
    start = rng.normal(0, 40, (na, na)).astype(np.float32)
    K = cal["ipc_kernel"]
    want = jsim.IL(_jax_lin(arrs), jnp.asarray(cal["gain"]), jnp.asarray(K),
                   start_e=jnp.asarray(start)).apply(jnp.asarray(counts))
    got = sim_to_l1.IL(_port_lin(arrs), torch.from_numpy(cal["gain"]),
                       torch.from_numpy(K), start_e=torch.from_numpy(start)
                       ).apply(torch.from_numpy(counts))
    _close(got.numpy(), want)
    # without a kernel: gain and linearity only
    want = jsim.IL(_jax_lin(arrs), jnp.asarray(cal["gain"])).apply(jnp.asarray(counts))
    got = sim_to_l1.IL(_port_lin(arrs), torch.from_numpy(cal["gain"])
                       ).apply(torch.from_numpy(counts))
    _close(got.numpy(), want)


@pytest.mark.parametrize("rp", [READ_PATTERN, [[0], [1], [2, 3], [5, 6, 7]],
                                [[1, 2], [4], [6, 7]]])
def test_contraction_matrix_is_mean_of_cumulative_charge(rp):
    T = sim_to_l1.contraction_matrix(rp)
    nreads = rp[-1][-1] + 1
    assert T.shape == (len(rp), nreads) and T.dtype == np.float32
    # the reference's construction (sim_to_l1.py:138-142)
    want = np.zeros((len(rp), nreads))
    for j, grp in enumerate(rp):
        for r in grp:
            want[j, : r + 1] += 1.0 / len(grp)
    want[:, 0] = 0.0
    np.testing.assert_array_equal(T, want.astype(np.float32))
    # resultant = mean over the group's reads of the charge collected
    # since read 0
    inc = np.random.RandomState(1).poisson(5.0, nreads).astype(np.float64)
    cum = np.cumsum(inc) - inc[0]
    _close(T.astype(np.float64) @ inc, [cum[g].mean() for g in rp], rtol=1e-6)
    assert sim_to_l1.read_pattern_to_tij(rp, 2.0) == jsim.read_pattern_to_tij(rp, 2.0)


def test_extract_reference_read_reshuffle():
    rng = np.random.RandomState(2)
    data = rng.randint(0, 65536, (4, 8, 8)).astype(np.uint16)
    amp = rng.randint(0, 65536, (4, 8, 2)).astype(np.uint16)
    tree = {"meta": {"exposure": {"read_pattern": [[0], [1], [2, 3], [4]],
                                  "nresultants": 4}, "instrument": {}},
            "data": data.copy(), "amp33": amp.copy(),
            "resultantdq": np.zeros((4, 8, 8), np.uint32)}
    sim_to_l1.extract_reference_read(tree, 4000)
    # the reference's arithmetic (sim_to_l1.py:711-732)
    for key, ref, src in (("data", "reference_read", data),
                          ("amp33", "reference_amp33", amp)):
        np.testing.assert_array_equal(tree[ref], src[0])
        modref = src[0].astype(np.int32) - 4000
        want = np.clip(src[1:].astype(np.int32) - modref[None], 0, 65535)
        np.testing.assert_array_equal(tree[key], want.astype(np.uint16))
        assert tree[key].dtype == np.uint16
    assert tree["meta"]["exposure"]["read_pattern"] == [[1], [2, 3], [4]]
    assert tree["meta"]["exposure"]["nresultants"] == 3
    assert tree["meta"]["instrument"]["data_encoding_offset"] == 4000
    assert tree["resultantdq"].shape[0] == 3


def test_pseudocalibrate_matches_reference_on_the_same_file(work):
    d, scene, caldir, *_ = work
    with sim_to_l1.Image2D_from_L1(d + "/L1.asdf", caldir) as y:
        got = y.pseudocalibrate(device="cpu")["roman"]
    with jsim.Image2D_from_L1(d + "/L1.asdf", caldir) as yj:
        want = yj.pseudocalibrate()["roman"]
    assert got["data"].shape == (NA, NA) and got["data"].dtype == np.float32
    _close(got["data"], want["data"])
    np.testing.assert_array_equal(got["dq"], want["dq"])
    with pytest.raises(ValueError, match="WCS"):
        sim_to_l1.Image2D_from_L1(d + "/L1.asdf", caldir, thewcs="x").pseudocalibrate(
            device="cpu")


@pytest.mark.parametrize("prefill", [True, False])
def test_make_ideal_l2_matches_reference_on_the_same_state(work, prefill):
    d, scene, caldir, c1, c2, x = work
    mine = sim_to_l1.Image2D.__new__(sim_to_l1.Image2D)
    ref = jsim.Image2D.__new__(jsim.Image2D)
    mine.af = asdf_lite.open(d + "/L1.asdf")
    ref.af = jasdf.open(d + "/L1.asdf")
    if prefill:
        for o in (mine, ref):
            o._resultants_prefill = x._resultants_prefill
            o._read_pattern_sim = x._read_pattern_sim
    got = mine.make_ideal_l2(caldir, device="cpu")["roman"]
    want = ref.make_ideal_l2(caldir)["roman"]
    _close(got["data"], want["data"])
    np.testing.assert_array_equal(got["dq"], want["dq"])
    assert mine.L2_write_to(d + f"/ideal_{prefill}.asdf")
    assert asdf_lite.open(d + f"/ideal_{prefill}.asdf")["roman"]["data"].shape == (NA, NA)


def test_skymodel_copy_matches_reference():
    for filt, ra, dec, date in (("F184", 37.0, -20.0, "2026-01-01T00:00:00Z"),
                                ("F213", 150.0, 2.2, "2027-06-30"),
                                ("W146", 270.0, 66.0, None), ("XXXX", 10.0, 0.0, "bad")):
        assert skymodel.sky_background_rate(filt, ra, dec, date) == \
            jskymodel.sky_background_rate(filt, ra, dec, date)


def test_scene_file_matches_reference(tmp_path):
    from romanimpreprocess_tpu.synth import make_scene_file as jmake

    a = synth.make_scene_file(str(tmp_path / "a_F184_1_4.fits"), nside_active=40, nstars=3)
    b = jmake(str(tmp_path / "b_F184_1_4.fits"), nside_active=40, nstars=3)
    assert open(a, "rb").read() == open(b, "rb").read()
    xa = sim_to_l1.Image2D("anlsim", fname=a)
    xb = jsim.Image2D("anlsim", fname=b)
    np.testing.assert_array_equal(xa.image, xb.image)
    assert (xa.idsca, xa.date, xa.filter, xa.ra_) == (xb.idsca, xb.date, xb.filter, xb.ra_)
    with pytest.raises(ValueError, match="_<obsid>_<sca>"):
        sim_to_l1.Image2D("anlsim", fname=str(tmp_path / "nosca.fits"))


def test_charge_rate_matches_reference_truth_rate(work):
    d, scene, caldir, c1, c2, x = work
    xj = jsim.run_config(dict(c1, OUT=d + "/L1_jax.asdf", FITSOUT=False))
    _close(x.truth_rate, xj.truth_rate)


# --------------------------------------------------------------------------
# the slice at the reference's gates
# --------------------------------------------------------------------------

def test_l1_format(work):
    d, *_ = work
    r = asdf_lite.open(d + "/L1.asdf")["roman"]
    assert r["data"].shape == (len(READ_PATTERN), N, N)
    assert r["data"].dtype == np.uint16
    assert r["amp33"].shape == (len(READ_PATTERN), N, 4)
    assert r["amp33"].dtype == np.uint16
    assert r["resultantdq"].shape == (len(READ_PATTERN), NA, NA)
    assert r["resultantdq"].dtype == np.uint32
    assert r["meta"]["exposure"]["read_pattern"] == READ_PATTERN
    # ramps must be increasing on average (charge accumulates)
    med = [np.median(r["data"][j].astype(np.float64)) for j in range(3)]
    assert med[2] > med[1] - 5
    assert abs(np.median(r["amp33"].astype(np.float64)) - 29000) < 50
    h = fits_lite.Header.fromstring(open(d + "/L1_asdf_wcshead.txt").read())
    assert "CRVAL1" in h
    wi = r["meta"]["wcsinfo"]
    assert wi["CRVAL1"] == float(h["CRVAL1"]) and wi["CD1_1"] == float(h["CD1_1"])
    # FITSOUT: the cube with the amp33 block appended
    out = fits_lite.open_fits(d + "/L1_asdf_to.fits")[0].data
    assert out.shape == (len(READ_PATTERN), N, N + 4)
    np.testing.assert_array_equal(out[:, :, :N], r["data"])
    np.testing.assert_array_equal(out[:, :, N:], r["amp33"])
    # the JAX package's reader takes the file as its own
    rj = jasdf.open(d + "/L1.asdf")["roman"]
    np.testing.assert_array_equal(rj["data"], r["data"])


def _expected(scene, caldir):
    pack = calfiles.load_caldir(caldir)
    truth = fits_lite.open_fits(scene)[0].data[::-1, :]  # SCA 4 -> vflip
    return truth / pack.gain[4:-4, 4:-4] / 139.8, pack


@pytest.mark.parametrize("l2name", ["L2.asdf", "L2_jax.asdf"])
def test_l2_slope_recovers_signal(work, l2name):
    """The port's L1 through the port's and through the JAX package's
    ``calibrateimage`` (gates of test_workflow.py:74-91 and
    test_run_all.py:92-101)."""
    d, scene, caldir, *_ = work
    r = asdf_lite.open(d + "/" + l2name)["roman"]
    expected, _ = _expected(scene, caldir)
    good = np.asarray(r["dq"]) == 0
    assert good.mean() > 0.8
    x = np.where(good, r["data_withsky"] - expected, 0.0)
    # sky (0.4 e/s through flat/gain) dominates the median residual
    assert 0.15 < np.median(x[good]) < 0.45
    assert (np.abs(x) > 5).sum() < 20
    xs = np.where(good, r["data"] - expected, 0.0)
    assert abs(np.median(xs[good])) < 0.1


def test_jax_calibration_recovers_the_ports_truth_rate(work):
    d, scene, caldir, c1, c2, x = work
    r = jasdf.open(d + "/L2_jax.asdf")["roman"]
    pack = calfiles.load_caldir(caldir)
    act = (slice(4, -4), slice(4, -4))
    area = wcsutils.pixelarea(x.wcs, N=NA) / pars.Omega_ideal
    expect = ((x.truth_rate / pack.gain[act] - pack.dark_slope[act])
              / np.clip(pack.flat[act], 0.1, 10.0) * area)
    good = np.asarray(r["dq"]) == 0
    got = np.asarray(r["data_withsky"])
    # faint sky (about 0.26 DN/s): an absolute gate, because one
    # exposure's 1/f realization shifts every slope by a few 0.01 DN/s,
    # in the reference's own sim as well
    faint = good & (expect > 0.2) & (expect < 1.0)
    assert faint.mean() > 0.7
    assert abs(np.median(got[faint] - expect[faint])) < 0.05
    # the stars: a relative gate
    bright = good & (expect > 20)
    assert bright.sum() > 20
    assert 0.97 < np.median(got[bright] / expect[bright]) < 1.03
    assert np.corrcoef(got[bright], expect[bright])[0, 1] > 0.99


@pytest.mark.parametrize("l2name", ["L2.asdf", "L2_jax.asdf"])
def test_cr_count_envelope_and_recall(work, l2name):
    d, *_ = work
    dq = np.asarray(asdf_lite.open(d + "/" + l2name)["roman"]["dq"])
    ndet = int(((dq & JUMP_DET) != 0).sum())
    # injected: 8e-6 /pix/s * 3.04 s * 13 live reads * 120^2 pixels
    # events, x3 track pixels -> ~14 expected flagged
    assert 2 <= ndet <= 60, ndet
    l1 = asdf_lite.open(d + "/L1.asdf")["roman"]
    truth = (np.asarray(l1["resultantdq"]) & JUMP_DET).any(axis=0)
    assert int(truth.sum()) >= 2
    recall = ((dq & JUMP_DET) != 0)[truth].mean()
    assert recall > 0.5, (recall, int(truth.sum()), ndet)


def test_cr_flags_run_from_the_hit_group_onward(work):
    d, *_ = work
    hit = (np.asarray(asdf_lite.open(d + "/L1.asdf")["roman"]["resultantdq"])
           & JUMP_DET) != 0
    assert not hit[0].any()  # read 0 is at t = 0
    assert (hit[1:] >= hit[:-1]).all()  # once hit, every later group
    assert hit[-1].sum() >= 2


def test_determinism(work, tmp_path):
    """Two runs with one seed give the same file (test_workflow.py:200);
    another seed gives another."""
    d, scene, caldir, c1, c2, x = work
    sim_to_l1.run_config(dict(c1, OUT=str(tmp_path / "b.asdf")), device="cpu")
    sim_to_l1.run_config(dict(c1, OUT=str(tmp_path / "c.asdf"), SEED=SEED + 1),
                         device="cpu")
    a = asdf_lite.open(d + "/L1.asdf")["roman"]
    b = asdf_lite.open(str(tmp_path / "b.asdf"))["roman"]
    c = asdf_lite.open(str(tmp_path / "c.asdf"))["roman"]
    for k in ("data", "amp33", "resultantdq"):
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["data"], c["data"])
    assert open(d + "/L1_asdf_wcshead.txt").read() == open(
        str(tmp_path / "b_asdf_wcshead.txt")).read()


def test_extract_ref_variant(work, tmp_path):
    d, scene, caldir, c1, c2, x = work
    out = str(tmp_path / "L1x.asdf")
    sim_to_l1.run_config(dict(c1, OUT=out, FITSOUT=False,
                              EXTRACT_REF={"data_encoding_offset": 4000}), device="cpu")
    f = asdf_lite.open(out)["roman"]
    assert f["data"].shape[0] == len(READ_PATTERN) - 1
    assert f["reference_read"].shape == (N, N)
    assert f["reference_amp33"].shape == (N, 4)
    assert f["meta"]["instrument"]["data_encoding_offset"] == 4000
    assert f["meta"]["exposure"]["read_pattern"] == READ_PATTERN[1:]
    # same seed: the reshuffle of the base run's cube
    base = asdf_lite.open(d + "/L1.asdf")["roman"]
    np.testing.assert_array_equal(f["reference_read"], base["data"][0])
    # and it still calibrates, in both packages (EXCLUDE_FIRST off)
    for cal, kw, name in ((l1_to_l2.calibrateimage, {"device": "cpu"}, "t"),
                          (jl1_to_l2.calibrateimage, {}, "j")):
        o = str(tmp_path / f"L2x_{name}.asdf")
        cal(dict(c2, IN=out, OUT=o, EXCLUDE_FIRST=False,
                 FITSWCS=str(tmp_path / "L1x_asdf_wcshead.txt")), **kw)
        r = asdf_lite.open(o)["roman"]
        assert r["data"].shape == (NA, NA) and np.isfinite(np.asarray(r["data"])).all()


RP5 = [[0], [1, 2], [3, 4, 5], [6, 7, 8], [9, 10]]


def test_cnorm_scales_scene_linearly(tmp_path):
    d = str(tmp_path)
    scene = synth.make_scene_file(d + "/truth_F184_163_4.fits", nside_active=56,
                                  nstars=4)
    caldir = synth.make_cal_files(d + "/roman_wfi", RP5, nside=64, seed=5)
    rates = {}
    for c in (1.0, 2.0, 3.0):
        x = sim_to_l1.run_config(
            {"IN": scene, "OUT": d + f"/L1_{c}.asdf", "READS": _reads(RP5),
             "CALDIR": caldir, "SEED": 200, "CNORM": c}, device="cpu")
        rates[c] = np.asarray(x.truth_rate, np.float64)
    d21 = rates[2.0] - rates[1.0]
    d32 = rates[3.0] - rates[2.0]
    pos = rates[1.0] > 0
    assert d21[pos].sum() > 0  # the scene contributes
    assert np.allclose(d32[pos], d21[pos], rtol=1e-5, atol=1e-7)


def test_no_amp33_bypasses_reference_output(tmp_path):
    d = str(tmp_path)
    scene = synth.make_scene_file(d + "/truth_F184_163_4.fits", nside_active=56,
                                  nstars=2)
    caldir = synth.make_cal_files(d + "/roman_wfi", RP5, nside=64, seed=5)
    base = {"IN": scene, "READS": _reads(RP5), "SEED": 200}
    sim_to_l1.run_config(dict(base, OUT=d + "/with.asdf", CALDIR=dict(caldir)),
                         device="cpu")
    sim_to_l1.run_config(dict(base, OUT=d + "/no.asdf",
                              CALDIR=dict(caldir, NO_AMP33=True)), device="cpu")
    r_with = asdf_lite.open(d + "/with.asdf")["roman"]
    r_no = asdf_lite.open(d + "/no.asdf")["roman"]
    assert "amp33" in r_with and "amp33" not in r_no
    assert np.asarray(r_with["amp33"]).mean() > 50.0  # med level present
    assert r_no["data"].shape == r_with["data"].shape


def test_persistence_hook(work, tmp_path):
    """make_l1_fullcal adds the persistence rate to the charge; the
    recovered ramp rate grows by persistence/gain DN/s (gate of
    test_workflow.py:250-285)."""
    d, scene, caldir, c1, c2, x = work
    pack = calfiles.load_caldir(caldir)
    rate = np.full((NA, NA), 1.0, np.float32)
    pers = np.full((NA, NA), 3.0, np.float32)
    r0, _ = sim_to_l1.make_l1_fullcal(rand.sim_generator(11, "cpu"), rate,
                                      READ_PATTERN, pack)
    r1, dq1 = sim_to_l1.make_l1_fullcal(rand.sim_generator(11, "cpu"), rate,
                                        READ_PATTERN, pack, persistence=pers)
    assert r1.dtype == torch.float32 and dq1.dtype == torch.int32
    assert not dq1.any()  # no cosmic rays without crparam
    tbar = np.array([np.mean(g) for g in READ_PATTERN]) * 3.04
    gmed = float(np.median(pack.gain))
    d0 = float((r0[-1] - r0[1]).mean()) / (tbar[-1] - tbar[1])
    d1 = float((r1[-1] - r1[1]).mean()) / (tbar[-1] - tbar[1])
    assert 2.4 < (d1 - d0) * gmed < 3.6

    pfile = str(tmp_path / "pers.fits")
    fits_lite.PrimaryHDU(pers * 10).writeto(pfile, overwrite=True)
    sim_to_l1.run_config(dict(c1, OUT=str(tmp_path / "L1p.asdf"), PERSISTENCE=pfile),
                         device="cpu")
    a = asdf_lite.open(d + "/L1.asdf")["roman"]["data"]
    b = asdf_lite.open(str(tmp_path / "L1p.asdf"))["roman"]["data"]
    act = (slice(4, -4), slice(4, -4))
    assert np.median(b[-1][act].astype(np.float64)) > np.median(
        a[-1][act].astype(np.float64)) + 100


def test_sky_rate_defaults_to_the_sky_model(work, tmp_path):
    d, scene, caldir, c1, c2, x = work
    want = skymodel.sky_background_rate("F184", 37.0, -20.0, "2026-01-01T00:00:00Z")
    lo = sim_to_l1.run_config(dict(c1, OUT=str(tmp_path / "a.asdf"), SKY_RATE=0.0,
                                   FITSOUT=False), device="cpu")
    flat = calfiles.load_caldir(caldir).flat[4:-4, 4:-4]
    # charge_rate adds sky_rate * (IPC-deconvolved flat)
    sky = (x.truth_rate - lo.truth_rate) / flat
    assert abs(np.median(sky) / want - 1.0) < 0.01


def test_resultant_moments_match_reference_over_8_seeds(tmp_path):
    """Port and JAX ``make_l1_fullcal`` on one rate map and one CALDIR,
    8 seeds each, no cosmic rays (their heavy tail swamps a variance):
    per group, the mean over pixels of the seed-mean, and of the
    seed-variance, agree within 4 sigma of their sampling error."""
    nside, na, nseed = 64, 56, 8
    caldir = synth.make_cal_files(str(tmp_path / "cal"), READ_PATTERN, nside=nside,
                                  seed=5)
    pack = calfiles.load_caldir(caldir)
    jpack = jcalfiles.load_caldir(caldir)
    yy, xx = np.mgrid[:na, :na]
    rate = (2.0 + 10.0 * xx / na + 40.0 * np.exp(
        -0.5 * ((xx - 20) ** 2 + (yy - 30) ** 2) / 9.0)).astype(np.float32)
    port = np.stack([sim_to_l1.make_l1_fullcal(
        rand.sim_generator(100 + s, "cpu"), rate, READ_PATTERN, pack)[0].numpy()
        for s in range(nseed)]).astype(np.float64)
    ref = np.stack([np.asarray(jsim.make_l1_fullcal(
        jrand.sim_key(100 + s), rate, READ_PATTERN, jpack)[0])
        for s in range(nseed)]).astype(np.float64)
    assert port.shape == ref.shape == (nseed, len(READ_PATTERN), na, na)
    npix = na * na
    vp, vr = port.var(axis=0, ddof=1), ref.var(axis=0, ddof=1)  # (ngrp, na, na)
    for j in range(len(READ_PATTERN)):
        dmean = (port.mean(axis=0)[j] - ref.mean(axis=0)[j]).mean()
        sig = np.sqrt((vp[j].mean() + vr[j].mean()) / (nseed * npix))
        assert abs(dmean) < 4 * sig, (j, dmean, sig)
        # Var(s^2) = 2 sigma^4 / (n - 1) for each pixel and package
        v = 0.5 * (vp[j].mean() + vr[j].mean())
        sig_v = v * np.sqrt(2 * 2.0 / ((nseed - 1) * npix))
        assert abs(vp[j].mean() - vr[j].mean()) < 4 * sig_v, (j, vp[j].mean(), vr[j].mean())
    # the ramp's growth is the rate: both packages, same slope per pixel
    tbar = np.array([np.mean(g) for g in READ_PATTERN]) * 3.04
    slope_p = (port[:, -1] - port[:, 1]).mean(axis=0) / (tbar[-1] - tbar[1])
    expect = rate / pack.gain[4:-4, 4:-4]
    assert abs(np.median(slope_p / expect) - 1.0) < 0.05


def test_fill_draws_border_banding_and_amp33(work):
    """The fill alone: active region = the input cube plus banding, the
    border a synthetic dark, odd channels mirrored, amp33 near its level."""
    d, scene, caldir, *_ = work
    pack = calfiles.load_caldir(caldir)
    ngrp = len(READ_PATTERN)
    im = torch.full((ngrp, NA, NA), 20000.0)
    out, a33 = sim_to_l1.fill_in_refdata_and_1f(
        rand.sim_generator(3, "cpu"), im, pack, READ_PATTERN, N, 4, amp33=np.zeros(1))
    assert out.shape == (ngrp, N, N) and out.dtype == torch.int32
    assert a33.shape == (ngrp, N, 4) and int(out.min()) >= 0 and int(out.max()) <= 65535
    act = out[:, 4:-4, 4:-4].numpy().astype(np.float64)
    assert abs(act.mean() - 20000.0) < 1.0 and 0.2 < act.std() < 3.0  # banding only
    border = out[:, :4, :].numpy().astype(np.float64)
    assert abs(border.mean() - pack.dark_cube[:, :4, :].mean()) < 5.0
    assert border.std() > 20.0  # shared reset noise ~ 25-30 DN
    assert abs(np.median(a33.numpy()) - 29000) < 5
    full, _ = sim_to_l1.fill_in_refdata_and_1f(
        rand.sim_generator(3, "cpu"), torch.nn.functional.pad(im, (4, 4, 4, 4)),
        pack, READ_PATTERN, N, 4, amp33=np.zeros(1))
    assert torch.equal(full, out)  # a full frame's active region is taken
    nobands, none = sim_to_l1.fill_in_refdata_and_1f(
        rand.sim_generator(3, "cpu"), im, pack, READ_PATTERN, N, 4,
        fill_in_banding=False)
    assert none is None and (nobands[:, 4:-4, 4:-4] == 20000).all()
    assert staging.u16_to_host(torch.tensor([0, 1, 32768, 65535])).tolist() == [
        0, 1, 32768, 65535]
