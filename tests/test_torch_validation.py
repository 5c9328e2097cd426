"""The port's validation drivers against the JAX package's, on the CPU.

``coadd_consumer``: ``resample`` and the CLI give the JAX module's
output exactly on the same L2 trees (synthetic products with an
analytic scene, and a pipeline product).  ``many_realizations``: the
serial driver (``nrun=4``, through the files) and the lane driver
(``nrun=8`` on a two-entry CPU mesh) meet the JAX test's gates
(``tests/test_validation.py``: finite stack, the ramp accumulates, median
bias over good pixels < 0.3 DN/s, reported error over empirical std in
0.3-4); slice 0 (the ideal slope) equals the JAX stack's; the median
std over good pixels is within 0.75-1.33 of the JAX serial driver's;
both refusals of the lane driver raise.  128^2 frames.
"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from romanimpreprocess_tpu.ops import wcsutils as jwcsutils
from romanimpreprocess_tpu.synth import make_cal_files, make_scene_file
from romanimpreprocess_tpu.validation import coadd_consumer as jcoadd
from romanimpreprocess_tpu.validation import many_realizations as jmany
from romanimpreprocess_tpu_torch import parallel
from romanimpreprocess_tpu_torch.io import asdf_lite
from romanimpreprocess_tpu_torch.pipeline import noise
from romanimpreprocess_tpu_torch.utils import parity
from romanimpreprocess_tpu_torch.validation import coadd_consumer, many_realizations

torch.set_num_threads(1)

READ_PATTERN = [[0], [1, 2], [3, 4, 5], [6, 7, 8], [9, 10]]
N = 128
NA = N - 8


# --------------------------------------------------------------------------
# coadd_consumer
# --------------------------------------------------------------------------

def _l2_tree(n=96, dq_frac=0.0, seed=0):
    """A synthetic L2 product (tests/test_coadd_consumer.py's contract
    surface): a distorted SIP TAN WCS, a plane in the pixel coordinates
    plus noise, random DQ flags."""
    w = jwcsutils.SIPWCS(
        crpix=[(n - 1) / 2.0, (n - 1) / 2.0],
        cd=[[-3.05e-5, 1.1e-6], [1.2e-6, 3.05e-5]], crval=[37.25, -20.5],
        a_coefs={(2, 0): 3.0e-7, (0, 2): -2.0e-7, (1, 1): 1.0e-7},
        b_coefs={(2, 0): -1.5e-7, (0, 2): 2.5e-7, (1, 1): -8.0e-8})
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n]
    data = (3.0 + 0.01 * x - 0.02 * y + rng.normal(0, 0.1, (n, n))).astype(np.float32)
    dq = np.where(rng.uniform(size=(n, n)) < dq_frac, 1, 0).astype(np.uint32)
    return {"roman": {
        "meta": {"wcsinfo": dict(w.to_cards(), pixel_convention="0-based, active region")},
        "data": data, "dq": dq,
        "err": rng.uniform(0.05, 0.2, (n, n)).astype(np.float32)}}


def _same(a, b):
    for k in ("data", "var", "coverage"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dq_frac,scale,shape,offset", [
    (0.0, 0.11, (40, 40), (0.0, 0.0)),
    (0.1, 0.08, (32, 48), (0.0, 0.0)),
    (0.0, 0.2, (64, 64), (0.002, -0.001)),  # partly off the detector
])
def test_resample_matches_jax(dq_frac, scale, shape, offset):
    tree = _l2_tree(dq_frac=dq_frac)
    grid = coadd_consumer.CoaddGrid(37.25 + offset[0], -20.5 + offset[1], scale, shape)
    jgrid = jcoadd.CoaddGrid(37.25 + offset[0], -20.5 + offset[1], scale, shape)
    _same(coadd_consumer.resample(coadd_consumer.L2Image(tree), grid),
          jcoadd.resample(jcoadd.L2Image(tree), jgrid))


def test_l2_image_needs_wcsinfo():
    tree = _l2_tree()
    del tree["roman"]["meta"]["wcsinfo"]
    with pytest.raises(ValueError, match="wcsinfo"):
        coadd_consumer.L2Image(tree)


# --------------------------------------------------------------------------
# many_realizations
# --------------------------------------------------------------------------

def _configs(d):
    scene = make_scene_file(d + "/truth_F184_163_4.fits", nside_active=NA, nstars=3)
    caldir = make_cal_files(d + "/roman_wfi", READ_PATTERN, nside=N, seed=5)
    reads = []
    for g in READ_PATTERN:
        reads += [g[0], g[-1] + 1]
    c1 = {"IN": scene, "OUT": d + "/L1.asdf", "READS": reads, "CALDIR": caldir,
          "SEED": 100}
    c2 = {"IN": d + "/L1.asdf", "OUT": d + "/L2.asdf",
          "FITSWCS": d + "/L1_asdf_wcshead.txt", "CALDIR": caldir, "SKYORDER": 2}
    return c1, c2


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tval"))
    c1, c2 = _configs(d)
    jstack = jmany.run_many(c1, c2, nrun=4)
    serial = many_realizations.run_many(c1, c2, nrun=4, outfile=d + "/many.fits",
                                        device="cpu")
    mesh = parallel.sca_mesh(devices=["cpu", "cpu"])
    lanes = many_realizations.run_many_mesh(c1, c2, nrun=8, mesh=mesh,
                                            outfile=d + "/many_mesh.fits")
    return dict(d=d, c1=c1, c2=c2, jax=jstack, serial=serial, mesh=lanes)


def _gates(stack, min_count, what):
    """tests/test_validation.py's gates (``parity.mc_stack``); returns
    the median std."""
    assert stack.shape == (8, N, N), what
    return parity.mc_stack(stack, min_count, what)["median_std"]


@pytest.mark.parametrize("driver,min_count", [("serial", 3), ("mesh", 6)])
def test_stack_gates_and_jax(stacks, driver, min_count):
    s = _gates(stacks[driver], min_count, driver)
    sj = _gates(stacks["jax"], 3, "jax")
    np.testing.assert_array_equal(stacks[driver][0], stacks["jax"][0])
    assert 0.75 < s / sj < 1.33, (driver, s, sj)
    out = stacks["d"] + ("/many.fits" if driver == "serial" else "/many_mesh.fits")
    assert os.path.exists(out)


def test_mesh_realizations_are_lane_runs(stacks):
    """The lanes draw from ``lane_seed(seed0 + b, j)``: the same seed0
    gives the same stack, another seed0 another one."""
    c1, c2 = stacks["c1"], stacks["c2"]
    mesh = parallel.sca_mesh(devices=["cpu", "cpu"])
    a = many_realizations.run_many_mesh(c1, c2, nrun=2, mesh=mesh, seed=5)
    b = many_realizations.run_many_mesh(c1, c2, nrun=2, mesh=mesh, seed=5)
    c = many_realizations.run_many_mesh(c1, c2, nrun=2, mesh=mesh, seed=6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a[2], c[2])
    assert noise.lane_seed(5, 0) != noise.lane_seed(6, 0)


def test_mesh_refusals(stacks):
    c1, c2 = stacks["c1"], stacks["c2"]
    mesh = parallel.sca_mesh(devices=["cpu"])
    with pytest.raises(ValueError, match="EXTRACT_REF"):
        many_realizations.run_many_mesh(
            dict(c1, EXTRACT_REF={"data_encoding_offset": 4000}), c2, 2, mesh=mesh)
    other = dict(c2["CALDIR"], gain=c2["CALDIR"]["gain"] + ".other")
    with pytest.raises(ValueError, match="CALDIR"):
        many_realizations.run_many_mesh(c1, dict(c2, CALDIR=other), 2, mesh=mesh)
    with pytest.raises(ValueError, match="broken pipe"):
        many_realizations.run_many(c1, dict(c2, IN=c2["IN"] + "x"), 2, device="cpu")


def test_coadd_cli_matches_jax_on_a_pipeline_product(stacks, tmp_path):
    """The CLI on the L2 product the serial driver's last realization
    left (``calibrate_tree`` does not write it: calibrate it once)."""
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2

    l2 = str(tmp_path / "L2.asdf")
    l1_to_l2.calibrateimage(dict(stacks["c2"], OUT=l2), device="cpu")
    outs = {}
    for name, mod in (("port", coadd_consumer), ("jax", jcoadd)):
        buf = io.StringIO()
        fits = str(tmp_path / f"stamp_{name}.fits")
        with redirect_stdout(buf):
            assert mod.main([l2, "--n", "24", "--out", fits]) == 0
        with open(fits, "rb") as f:
            outs[name] = (buf.getvalue().replace(fits, "STAMP"), f.read())
    assert outs["port"] == outs["jax"]
    _same(coadd_consumer.resample(coadd_consumer.open_l2(l2),
                                  coadd_consumer.CoaddGrid(*_center(l2), 0.11, (30, 30))),
          jcoadd.resample(jcoadd.open_l2(l2), jcoadd.CoaddGrid(*_center(l2), 0.11, (30, 30))))


def _center(l2):
    img = coadd_consumer.open_l2(l2)
    ny, nx = img.shape
    ra, dec = img.wcs.pix2world((nx - 1) / 2.0, (ny - 1) / 2.0)
    return float(ra), float(dec)


def test_written_stack_reads_back(stacks):
    from romanimpreprocess_tpu_torch.io import fits_lite

    got = fits_lite.open_fits(stacks["d"] + "/many.fits")[0].data
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  stacks["serial"].astype(np.float32))
    assert asdf_lite.open(stacks["c2"]["IN"])["roman"]["data"].shape[0] == len(READ_PATTERN)
