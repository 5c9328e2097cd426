"""The port's batch driver against itself and the JAX package, on the CPU.

The pure functions (``getval``, ``findcal``, ``scan_inputs``,
``build_configs`` / ``plan_jobs`` over a grid of exposures, SCAs,
``nmax``, seeds, reads and layers) equal the JAX package's exactly.  One
128^2 sweep of two SCAs (the JAX package's scenes and cal files, the
example noise layers) runs three times: the port serially, the port with
``--fpa`` (a one-entry CPU mesh), and the JAX package.  The port's two
runs write the same files bit for bit (the L2 log's ``Timing:`` line and
the output directory in the recorded configs aside).  Against the JAX
run, whose sims draw other streams: the same file set and tree keys (the
``typefix`` dummies included), each L2 within the sim envelope
(``parity.sim_envelope``) and each noise cube within ``compare_noise``.
"""

import itertools
import os

import numpy as np
import pytest
import torch

from romanimpreprocess_tpu.io import asdf_lite as jasdf
from romanimpreprocess_tpu.pipeline import batch as jbatch
from romanimpreprocess_tpu.synth import make_cal_files, make_scene_file
from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles, fits_lite
from romanimpreprocess_tpu_torch.pipeline import batch
from romanimpreprocess_tpu_torch.utils import parity

torch.set_num_threads(1)

READ_PATTERN = [[0], [1, 2], [3, 4, 5], [6, 7, 8], [9, 10]]
READS = "0,1,1,3,3,6,6,9,9,11"
LAYERS = "Rz4PbrS2C1,Rz4OS2C2"
N = 128
NA = N - 8
SCAS = (4, 5)


def test_constants_match_jax():
    assert batch.NSCA == jbatch.NSCA
    assert batch.DEFAULT_READS == jbatch.DEFAULT_READS
    assert batch.DEFAULT_LAYERS == jbatch.DEFAULT_LAYERS
    assert batch.L1_CTYPES == jbatch.L1_CTYPES and batch.L2_CTYPES == jbatch.L2_CTYPES


@pytest.mark.parametrize("argv,key,default", [
    (["--in=/x", "--seed=77"], "in", None),
    (["--in=/x", "--seed=77"], "seed", None),
    (["--in=/x", "--seed=77"], "missing", "dflt"),
    (["--layers=", "--fpa"], "layers", None),
    (["--fpa", "--sca=all"], "fpa", None),
    (["--sca=3", "--sca=4"], "sca", "1"),
])
def test_getval_matches_jax(argv, key, default):
    assert batch.getval(argv, key, default) == jbatch.getval(argv, key, default)


@pytest.mark.parametrize("ctype", batch.L2_CTYPES)
def test_findcal_matches_jax(ctype):
    for sca in (1, 7, 18):
        assert batch.findcal("/cal", "TAG", ctype, sca) == jbatch.findcal(
            "/cal", "TAG", ctype, sca)


def test_scan_inputs_matches_jax(tmp_path):
    d = str(tmp_path)
    for name in ("Roman_truth_F184_163_4.FITS", "Roman_truth_F184_164_4.fits",
                 "Roman_truth_H158_9_5.Fits", "notes.txt", "bad_name.fits",
                 "Roman_truth_F184_165_12.fits"):
        open(os.path.join(d, name), "w").close()
    for use in ([4], [4, 5], [12], list(range(1, 19))):
        assert batch.scan_inputs(d, use) == jbatch.scan_inputs(d, use)
    assert [(o, s) for _, _, o, s in batch.scan_inputs(d, [4])] == [(163, 4), (164, 4)]


def _scanned(nexp, scas):
    return [(f"/in/x_F184_{163 + i}_{sca}.fits", "F184", 163 + i, sca)
            for i in range(nexp) for sca in scas]


@pytest.mark.parametrize("nexp,scas,nmax", list(itertools.product(
    (1, 3), ((4,), (4, 5), (1, 18)), (1, 2, 999))))
def test_plan_jobs_matches_jax(nexp, scas, nmax):
    for (seed, dseed), reads, layers in itertools.product(
            ((500, 10), (7, 3)), (None, [0, 1, 1, 3]), (None, [], ["Rz2S2C1"])):
        kw = dict(output_dir="/o", cal_dir="/c", tag="T", seed=seed, dseed=dseed,
                  temp_dir="/t", reads=reads, layers=layers, nmax=nmax)
        got = batch.plan_jobs(_scanned(nexp, scas), **kw)
        want = jbatch.plan_jobs(_scanned(nexp, scas), **kw)
        assert got == want, kw
        for item, (c1, c2) in zip(*got):
            one = batch.build_configs(*item, output_dir="/o", cal_dir="/c", tag="T",
                                      seed=c1["SEED"], temp_dir="/t", reads=reads,
                                      layers=layers, dseed=dseed)
            assert one == (c1, c2)
            assert ("NOISE" in c2) == (layers is None or bool(layers))


# --------------------------------------------------------------------------
# one sweep, three runs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tbatch"))
    os.makedirs(d + "/IN")
    os.makedirs(d + "/CAL")
    for sca in SCAS:
        make_scene_file(d + f"/IN/Roman_Test_truth_F184_163_{sca}.fits",
                        nside_active=NA, nstars=3)
        make_cal_files(d + "/CAL/roman_wfi", READ_PATTERN, nside=N, seed=5,
                       tag="T", sca=sca)
    args = [f"--in={d}/IN", f"--cal={d}/CAL", "--tag=T", "--sca=all",
            f"--reads={READS}", f"--layers={LAYERS}"]
    batch.run(args + [f"--out={d}/OUT_S", "--device=cpu"])
    batch.run(args + [f"--out={d}/OUT_F", "--fpa", "--device=cpu"])
    jbatch.run(args + [f"--out={d}/OUT_J"])
    return d


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs if f != "ou.lock")


def _stem(sca):
    return f"F184_163_{sca}"


@pytest.mark.parametrize("sca", SCAS)
@pytest.mark.parametrize("kind", ["L1/sim_L1_{}.asdf", "L2/sim_L2_{}.asdf",
                                  "L2/sim_L2_{}_noise.asdf"])
def test_fpa_files_equal_serial(sweep, sca, kind):
    d = sweep
    rel = kind.format(_stem(sca))
    a = asdf_lite.open(f"{d}/OUT_S/{rel}").tree
    b = asdf_lite.open(f"{d}/OUT_F/{rel}").tree
    parity.same_tree(a, b, rel, subst=(f"{d}/OUT_S", f"{d}/OUT_F"))


@pytest.mark.parametrize("sca", SCAS)
def test_fpa_masks_and_sidecars_equal_serial(sweep, sca):
    d = sweep
    assert _files(d + "/OUT_S") == _files(d + "/OUT_F")
    for rel in (f"L2/sim_L2_{_stem(sca)}_mask.fits",
                f"L1/sim_L1_{_stem(sca)}_asdf_wcshead.txt"):
        with open(f"{d}/OUT_S/{rel}", "rb") as f, open(f"{d}/OUT_F/{rel}", "rb") as g:
            assert f.read() == g.read(), rel
    hdus = fits_lite.open_fits(f"{d}/OUT_F/L2/sim_L2_{_stem(sca)}_mask.fits")
    m = np.asarray(hdus[1].data)
    assert m.shape == (NA, NA) and set(np.unique(m)) <= {0, 1} and m.any()


@pytest.mark.parametrize("ext", [".asdf", ".fits"])
def test_convert_file_matches_jax_bytes(sweep, tmp_path, ext):
    from romanimpreprocess_tpu.ops.mask import PixelMask1 as JPixelMask1
    from romanimpreprocess_tpu_torch.ops.mask import PixelMask1

    l2 = f"{sweep}/OUT_S/L2/sim_L2_{_stem(4)}.asdf"
    PixelMask1.convert_file(l2, str(tmp_path / ("port" + ext)))
    JPixelMask1.convert_file(l2, str(tmp_path / ("jax" + ext)))
    with open(tmp_path / ("port" + ext), "rb") as f, open(tmp_path / ("jax" + ext), "rb") as g:
        # the ASDF header names the writing package, nothing else differs
        assert f.read().replace(b"author: romanimpreprocess_tpu_torch",
                                b"author: romanimpreprocess_tpu") == g.read()


def test_same_file_set_as_jax(sweep):
    assert _files(sweep + "/OUT_S") == _files(sweep + "/OUT_J")


@pytest.mark.parametrize("sca", SCAS)
def test_l2_against_jax(sweep, sca):
    d = sweep
    l2 = asdf_lite.open(f"{d}/OUT_S/L2/sim_L2_{_stem(sca)}.asdf")
    jl2 = jasdf.open(f"{d}/OUT_J/L2/sim_L2_{_stem(sca)}.asdf")
    assert set(l2["roman"]) == set(jl2["roman"])
    assert set(l2["roman"]["meta"]) == set(jl2["roman"]["meta"])
    assert l2["roman"]["meta"]["dummyfields"] == jl2["roman"]["meta"]["dummyfields"]
    assert set(l2["processinfo"]) == set(jl2["processinfo"])
    pack = calfiles.load_caldir(l2["processinfo"]["reffiles"])
    truth = fits_lite.open_fits(f"{d}/IN/Roman_Test_truth_F184_163_{sca}.fits")[0].data
    expected = truth[::-1, :] / pack.gain[4:-4, 4:-4] / 139.8  # SCAs 4, 5: vflip
    for tag, l2r, out in (("port", l2, "OUT_S"), ("jax", jl2, "OUT_J")):
        l1 = asdf_lite.open(f"{d}/{out}/L1/sim_L1_{_stem(sca)}.asdf")["roman"]
        parity.sim_envelope(l2r["roman"], l1, expected, f"SCA {sca} {tag}")


@pytest.mark.parametrize("sca", SCAS)
def test_noise_against_jax(sweep, sca):
    d = sweep
    rel = f"L2/sim_L2_{_stem(sca)}_noise.asdf"
    cube = np.asarray(asdf_lite.open(f"{d}/OUT_S/{rel}")["noise"])
    jcube = np.asarray(jasdf.open(f"{d}/OUT_J/{rel}")["noise"])
    good = np.asarray(jasdf.open(f"{d}/OUT_J/L2/sim_L2_{_stem(sca)}.asdf")["roman"]["dq"]) == 0
    good &= np.asarray(asdf_lite.open(f"{d}/OUT_S/L2/sim_L2_{_stem(sca)}.asdf")
                       ["roman"]["dq"]) == 0
    parity.compare_noise(jcube, cube, good, f"SCA {sca} noise")


def test_no_layers_no_noise_and_cuda_by_default(tmp_path):
    d = str(tmp_path)
    os.makedirs(d + "/IN")
    os.makedirs(d + "/CAL")
    make_scene_file(d + "/IN/Roman_Test_truth_F184_170_4.fits", nside_active=NA, nstars=2)
    make_cal_files(d + "/CAL/roman_wfi", READ_PATTERN, nside=N, seed=6, tag="T", sca=4)
    args = [f"--in={d}/IN", f"--cal={d}/CAL", "--tag=T", "--sca=4", f"--reads={READS}",
            "--layers=", f"--out={d}/OUT"]
    batch.run(args + ["--device=cpu"])
    assert _files(d + "/OUT") == sorted([
        "L1/sim_L1_F184_170_4.asdf", "L1/sim_L1_F184_170_4_asdf_wcshead.txt",
        "L2/sim_L2_F184_170_4.asdf", "L2/sim_L2_F184_170_4_mask.fits"])
    assert "NOISE" not in asdf_lite.open(d + "/OUT/L2/sim_L2_F184_170_4.asdf")[
        "processinfo"]["config"]
    if not torch.cuda.is_available():
        for extra in ([], ["--fpa"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                batch.run(args + extra)
