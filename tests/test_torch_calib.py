"""The port's calibration-file production against the JAX package, on the CPU.

The geometry of ``tests/test_calib.py`` (128^2 frames with a 4-column
amp33 block, the 5-group ``READS``, 4 dark exposures of 12 frames),
seeded with numpy.  The same raw frames go through both packages'
``convert`` and each package's chain builds its own CALDIR: dark and
read files (sigma-clipped stacks), gain and IPC files, p-flat,
saturation and bias correction from the synthetic generator's linearity
file, and the mask.  Tolerances, stated per test: the numpy writers'
arrays are equal; the sigma-clipped dark within rtol 1e-6 (the means
may differ in summation order); the bias correction within rtol 1e-5
plus atol 1e-5 max|ref|; the p-flat within rtol 1e-6.  Then one L1 is
calibrated by each package with its own CALDIR, and the port's L2 is
held to the JAX L2 by ``parity.compare_outputs`` with the sky gated
(``sky="derived"``).  Each CLI's ``main(argv)`` writes what its JAX twin
writes.  Every entry point defaults to ``cuda`` and raises here.
"""

import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from romanimpreprocess_tpu.calib import convert as jconvert
from romanimpreprocess_tpu.calib import make_dark as jmake_dark
from romanimpreprocess_tpu.calib import make_gain as jmake_gain
from romanimpreprocess_tpu.calib import makemask as jmakemask
from romanimpreprocess_tpu.calib import postprocess as jpostprocess
from romanimpreprocess_tpu.calib import swconfig as jswconfig
from romanimpreprocess_tpu.io import asdf_lite as jasdf
from romanimpreprocess_tpu.pipeline import l1_to_l2 as jl1_to_l2
from romanimpreprocess_tpu_torch import synth
from romanimpreprocess_tpu_torch.calib import (
    convert,
    make_dark,
    make_gain,
    makemask,
    mast,
    postprocess,
    swconfig,
)
from romanimpreprocess_tpu_torch.io import asdf_lite, fits_lite
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, sim_to_l1
from romanimpreprocess_tpu_torch.utils import parity

torch.set_num_threads(1)

READS = [0, 1, 1, 3, 3, 6, 6, 9, 9, 11]  # tests/test_calib.py:23
READ_PATTERN = [[0], [1, 2], [3, 4, 5], [6, 7, 8], [9, 10]]
N = 128
NB = 4
CW = N // 32
NAUG = N + CW
DT = 3.04
SCA = 4
L2_MAPS = ("data", "data_withsky", "err", "var_poisson", "var_rnoise")
KINDS = ("dark", "read", "gain", "ipc4d", "flat", "saturation", "biascorr", "mask")
#: the file-name kinds the CLIs derive from one another (the p-flat is ``_pflat_``)
CLI_KINDS = ("dark", "read", "gain", "ipc4d", "pflat", "saturation", "biascorr", "mask")


def _write_raw_frames(d, nframes, rng, dark_slope, bias):
    """Per-frame raw FITS in the Detector frame (SCA 4: rows flipped)."""
    paths = []
    for k in range(nframes):
        img = bias + dark_slope * DT * k + rng.normal(0, 6, (N, NAUG))
        frame = np.clip(np.round(img), 0, 65535).astype(np.uint16)[::-1, :]
        h = fits_lite.Header()
        h["DATE"] = f"2026-01-01T00:00:{k:02d}"
        p = f"{d}/frame_{k:03d}.fits"
        fits_lite.PrimaryHDU(frame, header=h).writeto(p)
        paths.append(p)
    return paths


def _noise_summary(path, dark_slope):
    """A solid-waffle noise summary (reference format), as
    ``tests/test_calib.py``'s fixture writes it."""
    planes = np.zeros((8, N, NAUG), np.float32)
    h = fits_lite.Header()
    h["DARK1"], h["DARK1ERR"], h["DARK2"], h["DARK2ERR"] = 0, 1, 2, 3
    h["CDS"], h["RESET"] = 4, 5
    h["ACN"], h["C_PINK"], h["U_PINK"] = 0.1, 0.8, 0.4
    planes[0] = planes[2] = dark_slope / DT
    planes[1], planes[3], planes[4], planes[5] = 0.01, 0.005, 8.5, 27.0
    a33 = np.zeros((2, N, CW), np.float32)
    a33[0], a33[1] = 29000.0, 4.0
    ah = fits_lite.Header()
    ah["EXTNAME"] = "AMP33"
    ah["M_PINK"], ah["RU_PINK"] = 0.8, 1.0
    fits_lite.HDUList([fits_lite.PrimaryHDU(), fits_lite.HDU(planes, header=h),
                       fits_lite.HDU(a33, header=ah)]).writeto(path)


def _sw_summaries(d):
    """Two solid-waffle gain summary tables (8 x 8 superpixels, one bad)."""
    rows = []
    for iy in range(8):
        for ix in range(8):
            row = np.zeros(12)
            row[[0, 1]] = ix, iy
            row[2] = 100 if (ix, iy) != (3, 3) else 0
            row[5], row[6], row[7], row[10] = 1.5 + 0.01 * ix, 0.013, 0.015, 0.002
            rows.append(row)
    paths = []
    for j in range(2):
        p = f"{d}/sw_summary_{j}.txt"
        np.savetxt(p, np.array(rows))
        paths.append(p)
    return paths


def _chain(pkg, d, raw, summary, sfiles, lin_path):
    """One package's production chain into ``d``; returns its CALDIR."""
    conv, mdark, mgain, post, mmask = pkg
    dev = {"device": "cpu"} if conv is convert else {}
    noise_files = []
    for e, frames in enumerate(raw, 1):
        out = f"{d}/99999999_SCA{SCA:02d}_Noise_{e:03d}.fits"
        conv.convert_exposure(frames, out, SCA, frame_time=DT)
        noise_files.append(out)
    dark = f"{d}/roman_wfi_dark_PROD_SCA{SCA:02d}.asdf"
    mdark.make_dark_and_read_files("TESTPAT", READS, noise_files, summary, SCA, dark,
                                   nside=N, **dev)
    gain = f"{d}/roman_wfi_gain_PROD_SCA{SCA:02d}.asdf"
    mgain.make_gain_and_ipc_files(sfiles, SCA, gain, nside=N)
    out = {k: f"{d}/roman_wfi_{k}_PROD_SCA{SCA:02d}.asdf"
           for k in ("flat", "saturation", "biascorr", "mask")}
    post.make_pflat_file(lin_path, gain, out["flat"], SCA, **dev)
    post.make_saturation_file(lin_path, out["saturation"], SCA)
    post.make_biascorr_file(lin_path, dark, out["biascorr"], SCA, READS, frame_time=DT,
                            **dev)
    mmask.make_mask_file(out["mask"], SCA, lin_path, dark, gain_file=gain, nside=N)
    return dict(out, dark=dark, read=dark.replace("_dark_", "_read_"), gain=gain,
                ipc4d=gain.replace("_gain_", "_ipc4d_"), linearitylegendre=lin_path,
                noise_files=noise_files)


@pytest.fixture(scope="module")
def prod(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tcalib"))
    rng = np.random.RandomState(77)
    dark_slope = 0.05 * 10.0 ** rng.normal(-0.3, 0.5, (N, NAUG))
    bias = 12000 + 100 * np.cos(np.arange(NAUG) / 17.0)[None, :]
    raw = []
    for e in range(1, 5):
        os.makedirs(f"{d}/raw{e}")
        raw.append(_write_raw_frames(f"{d}/raw{e}", 12, np.random.RandomState(e),
                                     dark_slope, bias))
    summary = d + "/noise_summary.fits"
    _noise_summary(summary, dark_slope)
    sfiles = _sw_summaries(d)
    syn = synth.make_cal_files(d + "/synsrc", READ_PATTERN, nside=N, seed=9, tag="SYN",
                               sca=SCA)
    with open(d + "/settings_TESTPAT.yaml", "w") as f:
        yaml.safe_dump({"READS": READS}, f)
    cal = {}
    for name, pkg in (("port", (convert, make_dark, make_gain, postprocess, makemask)),
                      ("jax", (jconvert, jmake_dark, jmake_gain, jpostprocess,
                               jmakemask))):
        os.makedirs(f"{d}/{name}")
        cal[name] = _chain(pkg, f"{d}/{name}", raw, summary, sfiles,
                           syn["linearitylegendre"])
    return dict(d=d, cal=cal, syn=syn, summary=summary, sfiles=sfiles)


def _roman(path, opener=asdf_lite):
    return opener.open(path)["roman"]


def test_convert_writes_the_same_cubes(prod):
    for a, b in zip(*(prod["cal"][k]["noise_files"] for k in ("port", "jax"))):
        ha, hb = fits_lite.open_fits(a), fits_lite.open_fits(b)
        assert ha[0].header["TGROUP"] == hb[0].header["TGROUP"] == DT
        for i in (1, 2):
            np.testing.assert_array_equal(ha[i].data, hb[i].data)
        assert ha[1].header["PROVEN"] == "romanimpreprocess_tpu_torch.calib.convert"


@pytest.mark.parametrize("kind", ["gain", "ipc4d", "saturation", "mask", "read"])
def test_host_writers_give_equal_arrays(prod, kind):
    """The numpy writers (and the read file, host arrays only): equal."""
    a = _roman(prod["cal"]["port"][kind])
    b = _roman(prod["cal"]["jax"][kind], jasdf)
    for k in ("data", "dq", "resetnoise"):
        if k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    assert a["meta"]["reftype"] == b["meta"]["reftype"]
    assert a["meta"]["origin"] == "PIT - romanimpreprocess_tpu_torch"
    if kind == "read":
        assert a["anc"] == b["anc"]
        for k in ("med", "std"):
            np.testing.assert_array_equal(a["amp33"][k], b["amp33"][k])


def test_dark_file_matches(prod):
    """The sigma-clipped group averages within rtol 1e-6; the slope
    planes (host numpy) equal."""
    a = _roman(prod["cal"]["port"]["dark"])
    b = _roman(prod["cal"]["jax"]["dark"], jasdf)
    assert a["data"].shape == b["data"].shape == (5, N, N)
    np.testing.assert_allclose(a["data"], b["data"], rtol=1e-6, atol=0)
    for k in ("dq", "dark_slope", "dark_slope_err"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["meta"]["exposure"] == b["meta"]["exposure"]


def test_pflat_matches(prod):
    """medfit in float32 on the device, the division in float64 on the
    host, as the JAX package does it: rtol 1e-6; the dq equal."""
    a = _roman(prod["cal"]["port"]["flat"])
    b = _roman(prod["cal"]["jax"]["flat"], jasdf)
    np.testing.assert_allclose(a["data"], b["data"], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(a["dq"], b["dq"])


def test_biascorr_matches(prod):
    """The per-read inverse-linearity forward model: rtol 1e-5 plus atol
    1e-5 max|ref|."""
    a = _roman(prod["cal"]["port"]["biascorr"])
    b = _roman(prod["cal"]["jax"]["biascorr"], jasdf)
    assert a["t0"] == b["t0"] == pytest.approx(DT * 1.5)
    ref = np.asarray(b["data"])
    np.testing.assert_allclose(a["data"], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_predicted_dark_cube_matches():
    """``predicted_dark_cube`` on one linearity pack in both packages,
    with a read outside every group (the JAX package's dropped sink):
    rtol 1e-5 plus atol 1e-5 max|ref|."""
    import jax.numpy as jnp

    from romanimpreprocess_tpu.ops import linearity as jlin
    from romanimpreprocess_tpu_torch.ops import linearity as lin

    na = 24
    cal = synth.synth_cal_arrays(na + 8, READ_PATTERN, seed=3)
    act = slice(NB, NB + na)
    planes = [np.ascontiguousarray(np.asarray(cal[k], np.float32)[..., act, act])
              for k in ("lin_coefs", "lin_smin", "lin_smax", "lin_sref")]
    rng = np.random.default_rng(5)
    dark = rng.uniform(0.01, 2.0, (na, na)).astype(np.float32)
    rp = [[0], [1, 2], [4, 5, 6]]  # read 3 lies in no group
    dq = np.zeros((na, na), np.uint32)
    want = jpostprocess.predicted_dark_cube(
        dark, jlin.LinearityData(*(jnp.asarray(p) for p in planes), jnp.asarray(dq)),
        rp, DT, 1.5)
    got = postprocess.predicted_dark_cube(
        dark, lin.LinearityData(*(torch.from_numpy(p) for p in planes),
                                torch.zeros((na, na), dtype=torch.int32)),
        rp, DT, 1.5, device="cpu")
    assert got.shape == (3, na, na) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_sigma_clip_mean_against_jax_and_numpy():
    """Survivor counts equal to the numpy model of astropy's clip (the
    JAX test's oracle, whose counts the JAX function reproduces); means
    within rtol 1e-6 of the JAX package's.  NaN in one exposure, an
    all-NaN pixel, and large outliers, above and below."""
    rng = np.random.default_rng(11)
    stack = rng.normal(1000.0, 5.0, (12, 9, 11)).astype(np.float32)
    stack[3, 2, 2] += 500.0
    stack[7, 0, 0] -= 300.0
    stack[[1, 4], 6, 6] += [80.0, -60.0]
    stack[5, 1, 1] = np.nan
    stack[:, 4, 4] = np.nan

    a = stack.astype(np.float64)
    for _ in range(5):
        with np.errstate(invalid="ignore"), pytest.warns(RuntimeWarning):
            med, std = np.nanmedian(a, axis=0), np.nanstd(a, axis=0)
        with np.errstate(invalid="ignore"):
            a[(a < med - 3 * std) | (a > med + 3 * std)] = np.nan
    want_count = np.isfinite(a).sum(axis=0)

    mean, count = make_dark.sigma_clip_mean(torch.from_numpy(stack), counts=True)
    np.testing.assert_array_equal(count.numpy(), want_count)
    assert count[2, 2] == 11 and count[4, 4] == 0 and count[1, 1] == 11
    want = np.asarray(jmake_dark.sigma_clip_mean(stack))
    np.testing.assert_allclose(mean.numpy(), want, rtol=1e-6, atol=0)
    assert mean[4, 4] == 0.0


def test_produced_caldirs_calibrate_alike(prod, tmp_path):
    """The chain closes in both packages: an exposure simulated by the
    port against its CALDIR, calibrated by each package with its own
    CALDIR, at the slice's gates with the sky gated."""
    from romanimpreprocess_tpu_torch.config import pattern_to_reads

    d = str(tmp_path)
    cals = {k: {kind: prod["cal"][k][kind] for kind in KINDS + ("linearitylegendre",)}
            for k in ("port", "jax")}
    scene = synth.make_scene_file(f"{d}/truth_F184_9_{SCA}.fits", nside_active=N - 8,
                                  nstars=4)
    sim_to_l1.run_config({"IN": scene, "OUT": d + "/L1.asdf", "READS": READS,
                          "CALDIR": cals["port"], "SEED": 3}, device="cpu")
    assert pattern_to_reads(READ_PATTERN) == READS
    c2 = {"IN": d + "/L1.asdf", "FITSWCS": d + "/L1_asdf_wcshead.txt", "SKYORDER": 2,
          "SLICEOUT": True}
    l1_to_l2.calibrateimage(dict(c2, OUT=d + "/L2.asdf", CALDIR=cals["port"]),
                            device="cpu")
    jl1_to_l2.calibrateimage(dict(c2, OUT=d + "/L2j.asdf", CALDIR=cals["jax"]))
    got, ref = asdf_lite.open(d + "/L2.asdf"), jasdf.open(d + "/L2j.asdf")

    def outs(t):
        im, pi = t["roman"], t["processinfo"]
        o = {k: np.asarray(im[k]) for k in L2_MAPS}
        o.update(pdq=np.asarray(im["dq"]), skycoefs=np.asarray(pi["skycoefs"]),
                 medsky=np.asarray(pi["medsky"]), endslice=np.asarray(pi["endslice"]))
        return o

    rep = parity.compare_outputs(outs(ref), outs(got), "produced CALDIR", maps=L2_MAPS,
                                 sky="derived")
    assert rep["skycoefs_within_gate"] and rep["medsky_within_gate"]
    good = np.asarray(got["roman"]["dq"]) == 0
    assert good.mean() > 0.5
    assert np.isfinite(np.asarray(got["roman"]["data"])[good]).all()


def _same_asdf_arrays(a, b, rtol=0.0):
    ta, tb = _roman(a), _roman(b, jasdf)
    keys = [k for k in tb if isinstance(tb[k], np.ndarray)]
    assert keys and set(keys) <= set(ta)
    for k in keys:
        np.testing.assert_allclose(np.asarray(ta[k]), np.asarray(tb[k]), rtol=rtol,
                                   atol=0, err_msg=k)


def test_cli_convert(tmp_path):
    d = str(tmp_path)
    rng = np.random.RandomState(3)
    for e in (1, 2):
        for k in range(3):
            img = 12000.0 + 0.05 * DT * k + rng.normal(0, 6, (N, NAUG))
            frame = np.clip(np.round(img), 0, 65535).astype(np.uint16)[::-1, :]
            fits_lite.PrimaryHDU(frame).writeto(
                f"{d}/Total_Noise_exp{e}_SCU04_000{k:x}.fits")
    for name in ("out", "jout"):
        os.makedirs(f"{d}/{name}")
    assert convert.main(["dark", d, "3", d + "/out", "4", "--device", "cpu"]) == 0
    assert jconvert.main(["dark", d, "3", d + "/jout", "4"]) == 0
    for e in (1, 2):
        name = f"99999999_SCA04_Noise_{e:03d}.fits"
        a, b = fits_lite.open_fits(f"{d}/out/{name}"), fits_lite.open_fits(f"{d}/jout/{name}")
        for i in (1, 2):
            np.testing.assert_array_equal(a[i].data, b[i].data)
    assert convert.main(["flt", d, "3", d + "/out", "4", "--device", "cpu"]) == 1


def test_clis_write_what_jax_writes(prod, tmp_path):
    """make_dark, make_gain, postprocess and makemask through their CLIs
    write what the JAX CLIs write (the dark's clipped means and the bias
    correction within the tolerances above, the rest equal)."""
    d, w = prod["d"], str(tmp_path)
    out = {}
    for name, mods in (("port", (make_dark, make_gain, postprocess, makemask)),
                       ("jax", (jmake_dark, jmake_gain, jpostprocess, jmakemask))):
        os.makedirs(f"{w}/{name}")
        dev = ["--device", "cpu"] if name == "port" else []
        mdark, mgain, post, mmask = mods
        base = f"{w}/{name}/roman_wfi_linearitylegendre_CLI_SCA{SCA:02d}.asdf"
        sub = base.replace
        assert mdark.main(["TESTPAT", prod["cal"]["port"]["noise_files"][0],
                           prod["summary"], str(SCA), sub("_linearitylegendre_", "_dark_"),
                           "--settings", d + "/settings_TESTPAT.yaml", "--nside", str(N)]
                          + dev) == 0
        lst = f"{w}/{name}/summaries.txt"
        with open(lst, "w") as f:
            f.write("\n".join(prod["sfiles"]) + "\n")
        assert mgain.main([lst, str(SCA), sub("_linearitylegendre_", "_gain_"),
                           "--nside", str(N)] + dev) == 0
        shutil.copy(prod["syn"]["linearitylegendre"], base)
        assert post.main([base, str(SCA), "TESTPAT", "--settings",
                          d + "/settings_TESTPAT.yaml", "--frame-time", str(DT)] + dev) == 0
        assert mmask.main([sub("_linearitylegendre_", "_mask_"), str(SCA), "--nside",
                           str(N)] + dev) == 0
        out[name] = {k: sub("_linearitylegendre_", f"_{k}_") for k in CLI_KINDS}
    for kind in CLI_KINDS:
        rtol = {"dark": 1e-6, "biascorr": 1e-5, "pflat": 1e-6}.get(kind, 0.0)
        _same_asdf_arrays(out["port"][kind], out["jax"][kind], rtol=rtol)


def test_cli_swconfig(tmp_path, capsys):
    for mod, dev in ((swconfig, ["--device", "cpu"]), (jswconfig, [])):
        assert mod.main(["correlation", "/data", "7", "1", "10", "--out",
                         str(tmp_path / f"{mod.__name__}.cfg")] + dev) == 0
        assert mod.main(["linearity", "/data", "7", "TAG"] + dev) == 0
    printed = capsys.readouterr().out
    texts = [open(tmp_path / f"{m.__name__}.cfg").read() for m in (swconfig, jswconfig)]
    assert texts[0] == texts[1] and "DETECTOR: SCA07" in texts[0]
    assert printed.count('"SCA": 7') == 2


def test_mast_uncal_matches(tmp_path):
    from romanimpreprocess_tpu.calib import mast as jmast

    rng = np.random.RandomState(0)
    data = rng.randint(0, 60000, (4, 64, 64)).astype(np.uint16)
    a33 = rng.randint(0, 60000, (4, 64, 8)).astype(np.uint16)
    src = str(tmp_path / "r0_WFI04_uncal.asdf")
    asdf_lite.AsdfFile({"roman": {"data": data, "amp33": a33}}).write_to(src)
    a = fits_lite.open_fits(mast.uncal_asdf_to_fits(src, str(tmp_path / "a.fits")))
    b = fits_lite.open_fits(jmast.uncal_asdf_to_fits(src, str(tmp_path / "b.fits")))
    np.testing.assert_array_equal(a[1].data, b[1].data)
    assert a[0].header["TGROUP"] == b[0].header["TGROUP"]


@pytest.mark.parametrize("call", [
    lambda p: make_dark.group_average_darks(p["cal"]["port"]["noise_files"], READ_PATTERN),
    lambda p: postprocess.make_pflat_file(p["syn"]["linearitylegendre"],
                                          p["cal"]["port"]["gain"], p["d"] + "/x.asdf", SCA),
    lambda p: postprocess.make_biascorr_file(p["syn"]["linearitylegendre"],
                                             p["cal"]["port"]["dark"], p["d"] + "/x.asdf",
                                             SCA, READS),
    lambda p: make_dark.main(["TESTPAT", p["cal"]["port"]["noise_files"][0], p["summary"],
                              "4", p["d"] + "/x_dark_.asdf", "--settings",
                              p["d"] + "/settings_TESTPAT.yaml"]),
    lambda p: make_gain.main(["x", "4", "y"]),
    lambda p: makemask.main(["x_mask_", "4"]),
    lambda p: convert.main(["dark", "x", "3", "y", "4"]),
    lambda p: swconfig.main(["linearity", "/data", "7", "TAG"]),
    lambda p: postprocess.main(["x_linearitylegendre_", "4", "TESTPAT"]),
], ids=["group_average_darks", "make_pflat_file", "make_biascorr_file", "make_dark.main",
        "make_gain.main", "makemask.main", "convert.main", "swconfig.main",
        "postprocess.main"])
def test_entry_points_default_to_cuda(prod, call):
    """Without ``device`` / ``--device`` an entry point runs on ``cuda``;
    without a GPU it raises before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(prod)
