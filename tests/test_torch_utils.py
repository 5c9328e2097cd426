"""The port's host utils against the JAX package, and the derived sky gate.

``orientation``, ``diff``, ``fpaplot``, ``visualize``, ``context_figure``
and ``profiling``: the same inputs (seeded with numpy, 128^2 frames)
through both packages give equal matrices, FITS arrays and mosaic
pixels; ``visualize`` writes a PDF; ``profiling.trace`` writes a
``torch.profiler`` Chrome trace.  ``parity.sky_bounds``: a slope map
perturbed by a known amount moves ``medsky`` and ``skycoefs`` within the
bound derived from that amount, and the gate trips past it.
``parity.bit_differences``: the share, ulps and value of what differs.
"""

import json
import os

import numpy as np
import pytest
import torch

from romanimpreprocess_tpu.ops.mask import PixelMask1 as jPixelMask1
from romanimpreprocess_tpu.utils import diff as jdiff
from romanimpreprocess_tpu.utils import fpaplot as jfpaplot
from romanimpreprocess_tpu.utils import orientation as jorientation
from romanimpreprocess_tpu_torch import synth
from romanimpreprocess_tpu_torch.io import asdf_lite, fits_lite
from romanimpreprocess_tpu_torch.ops import sky
from romanimpreprocess_tpu_torch.ops.mask import PixelMask1
from romanimpreprocess_tpu_torch.utils import (
    context_figure,
    diff,
    fpaplot,
    orientation,
    parity,
    profiling,
    visualize,
)

torch.set_num_threads(1)

READ_PATTERN = [[0], [1, 2], [3, 4, 5]]
N = 128


@pytest.fixture(scope="module")
def l1file(tmp_path_factory):
    """tests/test_viz.py's L1: 3 groups 40 DN apart, read noise 5 DN."""
    d = str(tmp_path_factory.mktemp("tutils"))
    rng = np.random.RandomState(0)
    data = 12000 + 40 * np.arange(3)[:, None, None] + rng.normal(0, 5, (3, N, N))
    data = np.clip(np.round(data), 0, 65535).astype(np.uint16)
    asdf_lite.AsdfFile({"roman": {"data": data, "meta": {
        "exposure": {"read_pattern": READ_PATTERN}}}}).write_to(d + "/L1.asdf")
    return d


@pytest.mark.parametrize("ra,dec,roll,scale", [(80.0, -69.0, 0.0, 1.0),
                                               (10.0, 5.0, 30.0, 1.0001),
                                               (250.0, 60.0, -115.0, 0.9999)])
def test_orientation_matches_jax(ra, dec, roll, scale):
    tree = {"roman": {"meta": {"wcsinfo": {"ra_ref": ra, "dec_ref": dec,
                                           "roll_ref": roll},
                               "velocity_aberration": {"scale_factor": scale}}}}
    deg = np.pi / 180
    np.testing.assert_array_equal(
        orientation.fpa_to_j2000_matrix(ra * deg, dec * deg, roll * deg),
        jorientation.fpa_to_j2000_matrix(ra * deg, dec * deg, roll * deg))
    got, want = orientation.get_orientation(tree), jorientation.get_orientation(tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_diff_matches_jax(l1file):
    d = l1file
    diff.main(["prog", d + "/L1.asdf", d + "/d.fits", "0", "2"])
    jdiff.main(["prog", d + "/L1.asdf", d + "/jd.fits", "0", "2"])
    a = fits_lite.open_fits(d + "/d.fits")[0].data
    np.testing.assert_array_equal(a, fits_lite.open_fits(d + "/jd.fits")[0].data)
    assert a.shape == (N, N) and 60 < np.median(a) < 100


def test_visualize_writes_a_pdf(l1file):
    d = l1file
    visualize.visualize([None, d + "/L1.asdf", "8,40,16,48", d + "/strip.pdf", 0.5])
    with open(d + "/strip.pdf", "rb") as f:
        assert f.read(5) == b"%PDF-"
    assert os.path.getsize(d + "/strip.pdf") > 1000


def test_context_figure_restores_the_backend():
    import matplotlib
    import matplotlib.pyplot as plt

    before = matplotlib.get_backend()
    with context_figure.ReportFigContext(matplotlib, plt, usetex=False):
        assert matplotlib.get_backend().lower() == "agg"
    assert matplotlib.get_backend() == before


@pytest.fixture(scope="module")
def calset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tfpa_plot"))
    for sca in (1, 4):
        synth.make_cal_files(f"{d}/roman_wfi", READ_PATTERN, nside=N, seed=sca, tag="V",
                             sca=sca)
    return d + "/roman_wfi_{:s}_V_SCA{:02d}.asdf"


@pytest.mark.parametrize("ptype", ["gain", "alphaH", "lin2", "read"])
def test_fpaplot_reads_the_same_images(calset, ptype):
    a = fpaplot.read_sca_image(calset, 64, ptype, 4, mask=PixelMask1)
    b = jfpaplot.read_sca_image(calset, 64, ptype, 4, mask=jPixelMask1)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (64, 64) and np.nanmax(a) > 0


def test_fpaplot_mosaics_are_equal(calset):
    a = fpaplot.make_big_image(calset, 64, "gain", vmin=1.2, vmax=2.1, mask=PixelMask1,
                               scaleformat="{:4.2f}")
    b = jfpaplot.make_big_image(calset, 64, "gain", vmin=1.2, vmax=2.1, mask=jPixelMask1,
                                scaleformat="{:4.2f}")
    assert a.dtype == np.uint8 and a.shape[-1] == 3 and (a != 255).any()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fpaplot.multi_image(calset, 32, PixelMask1),
                                  jfpaplot.multi_image(calset, 32, jPixelMask1))


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    log = str(tmp_path / "prof")
    with profiling.trace(log, create_perfetto_link=True) as prof:
        x = torch.ones((64, 64))
        (x @ x).sum()
    with open(os.path.join(log, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0
    # the trace is written when the body raises, too
    with pytest.raises(ValueError), profiling.trace(str(tmp_path / "err")):
        raise ValueError("inside")
    assert os.path.exists(tmp_path / "err" / profiling.TRACE_FILE)


# ---- the derived sky gate (parity.sky_bounds) ----

NA = 120


def _sky_outputs(m, jump=None):
    """The sky fields of an L2 as ``compare_outputs`` reads them, from an
    (NA, NA) with-sky map through the core's own sky stages."""
    t = torch.from_numpy(m)
    coefs, _ = sky.medfit(t, order=2)
    medsky, _ = sky.smooth_mode(sky.binkxk(t, 4))
    pdq = np.zeros((NA, NA), np.uint32) if jump is None else jump
    return {"data_withsky": m, "pdq": pdq, "skycoefs": coefs.numpy(),
            "medsky": np.asarray(float(medsky)), "endslice": np.zeros((NA, NA), np.int8)}


def _faint_sky(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:NA, :NA] / NA
    return (0.05 + 0.1 * xx - 0.05 * yy ** 2 + rng.normal(0, 0.3, (NA, NA))).astype(
        np.float32)


@pytest.mark.parametrize("delta", [1e-5, 2e-4, 3e-3])
def test_sky_gate_holds_a_known_perturbation(delta):
    """Each pixel moved by up to ``delta``: the sky moves within the
    derived bound, which is no looser than the rule it states."""
    m = _faint_sky(1)
    rng = np.random.default_rng(2)
    p = (m + rng.uniform(-delta, delta, m.shape)).astype(np.float32)
    ref, got = _sky_outputs(m), _sky_outputs(p)
    rep = parity.compare_outputs(ref, got, "perturbed", maps=(), sky="derived")
    real = float(np.abs(p.astype(np.float64) - m).max())
    assert rep["sky_delta"] == pytest.approx(real) and rep["sky_loose_pixels"] == 0
    A = parity.medfit_matrix(NA, NA, np.ones(64, bool), 2)
    bound = 1e-4 * np.abs(ref["skycoefs"]).max() + np.abs(A).sum(axis=1) * real
    np.testing.assert_allclose(rep["skycoefs_bound"], bound, rtol=1e-9)
    assert rep["medsky_bound"] == pytest.approx(1e-4 * abs(float(ref["medsky"])) + real)
    # the coefficient map is medfit's own: A @ block medians
    meds = sky.block_nanmedian(torch.from_numpy(m), 8).numpy().ravel()
    np.testing.assert_allclose(A @ meds, ref["skycoefs"], rtol=0, atol=1e-6)
    assert rep["skycoefs_max_abs_err"] <= max(bound)


def test_sky_gate_trips_past_the_bound():
    m = _faint_sky(3)
    p = (m + np.random.default_rng(4).uniform(-1e-4, 1e-4, m.shape)).astype(np.float32)
    ref, got = _sky_outputs(m), _sky_outputs(p)
    rep = parity.compare_outputs(ref, got, "ok", maps=(), sky="derived")
    for k in range(len(ref["skycoefs"])):
        bad = dict(got, skycoefs=got["skycoefs"].copy())
        bad["skycoefs"][k] = ref["skycoefs"][k] + 1.01 * rep["skycoefs_bound"][k]
        with pytest.raises(parity.ParityError, match="skycoefs"):
            parity.compare_outputs(ref, bad, "coef", maps=(), sky="derived")
    bad = dict(got, medsky=np.asarray(float(ref["medsky"]) - 1.01 * rep["medsky_bound"]))
    with pytest.raises(parity.ParityError, match="medsky"):
        parity.compare_outputs(ref, bad, "medsky", maps=(), sky="derived")
    # the default gate (rtol 1e-4) stays as strict as it was
    with pytest.raises(parity.ParityError, match="skycoefs|medsky"):
        parity.compare_outputs(ref, got, "rtol", maps=(), sky="rtol")


def test_sky_gate_counts_a_loose_pixel_as_an_order_statistic():
    """A pixel whose JUMP_DET differs may take any value: its block's
    median may move by one order statistic, and the bound counts that
    gap, while the map's own difference stays that of the other
    pixels."""
    m = _faint_sky(5)
    m[50, 60] = -1.0  # below its block's median
    p = m.copy()
    p[50, 60] = 40.0  # a cosmic ray that one fit flags and the other keeps
    jump = np.zeros((NA, NA), np.uint32)
    jump[50, 60] = parity.JUMP_DET
    ref, got = _sky_outputs(m), _sky_outputs(p, jump)
    rep = parity.compare_outputs(ref, got, "loose", maps=("data_withsky",),
                                 sky="derived")
    assert rep["sky_loose_pixels"] == 1 and rep["sky_delta"] == 0.0
    assert rep["skycoefs_max_abs_err"] > 0
    assert max(rep["skycoefs_bound"]) > 1e-4 * np.abs(ref["skycoefs"]).max()


def test_bit_differences_reads_ulps_and_values():
    """Two values either side of 0 are as many ulps apart as there are
    floats between them, however close in value; NaN equals NaN."""
    ref = {"a": np.array([1.0, -1e-30, np.nan, 2.0], np.float32),
           "dq": np.array([1, 2], np.uint32)}
    got = {"a": np.array([1.0, 1e-30, np.nan, np.nextafter(np.float32(2), np.float32(3))],
                         np.float32),
           "dq": np.array([1, 3], np.uint32)}
    rep = parity.bit_differences(ref, got)
    assert rep["a"]["share"] == 0.5
    assert rep["a"]["max_ulps"] == 2 * int(np.float32(1e-30).view(np.int32))
    assert rep["a"]["max_abs"] == np.spacing(np.float32(2))
    assert rep["dq"] == {"share": 0.5, "max_ulps": None, "max_abs": None}
