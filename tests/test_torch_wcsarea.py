"""The port's pixel-area map (``ops/wcsutils.pixelarea``, torch float64
on a device) and its path through the L1 -> L2 host wrapper
(``area_factor_from_config``, ``prepare_inputs``), on the CPU.

The map is held to the JAX package's ``pixelarea`` (numpy) and to the
benchmark's frozen copy of the arithmetic (``gpubench/wcsarea.py``) at
64^2 and 128^2, for TAN-SIP headers south, north and across dec 0.  The
Jacobian differences coordinates of order 1 over two pixels: near the
equator ``|u|`` is about 1.4, where one float64 rounding is 2.2e-16, and
a difference over two pixels about 7.5e-7, so each rounding moves a
pixel's area by about 3e-10 of itself.  The JAX package's numpy
(another libm, a round trip through degrees) differs from the port by
up to 4.9e-10 at +-40 deg and 1.2e-9 across the equator at 128^2, whence
:data:`RTOL` = 2e-9 (about seven roundings); the frozen copy runs the
port's torch operations in the port's order and is met bit for bit.  The
same arithmetic in float32 misses by more than 1e-3."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import spec, wcsarea  # noqa: E402
from romanimpreprocess_tpu.ops import wcsutils as jwcsutils  # noqa: E402
from romanimpreprocess_tpu_torch import pars, synth  # noqa: E402
from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles  # noqa: E402
from romanimpreprocess_tpu_torch.ops import wcsutils  # noqa: E402
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2  # noqa: E402
from romanimpreprocess_tpu_torch.utils import profiling  # noqa: E402

#: the map against the JAX package's: about seven float64 roundings of
#: the coordinates (see the module docstring)
RTOL = 2e-9
#: CRVAL2 (deg) of the cases south and north; across the equator, the
#: first pixel's dec (deg) just north / just south of 0, the frame rolled
#: so that the rest of the field lies mostly across it
DECS = {"south": -40.0, "north": 40.0, "equator_n": 1e-4, "equator_s": -1e-4}
ROLLS = {"equator_n": 213.0}

wcs_entry = spec.entry("l1_to_l2_wcs")
torch.set_num_threads(2)


def _cards(n, where):
    """A TAN-SIP header of an ``n``^2 frame (the benchmark's SCA header,
    third-order SIP), its CRVAL2 from :data:`DECS`, as a sidecar holds it."""
    cards = wcsarea.header(11, 2, 0, 150.0, 0.0, ROLLS.get(where, 33.0), n + 8, 4)
    cards["CRVAL2"] = DECS[where]
    if where.startswith("equator"):  # the first pixel DECS[where] from dec 0
        cards["CRVAL2"] = 0.0
        w = wcsutils.SIPWCS.from_header(cards, zero_based=True)
        cards["CRVAL2"] = DECS[where] - float(w.pix2world(-1.0, -1.0)[1])
    return wcs_entry.as_written(cards)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("where", list(DECS))
@pytest.mark.parametrize("n", [64, 128])
def test_pixelarea_matches_the_jax_package_and_the_frozen_copy(tmp_path, n, where):
    cards = _cards(n, where)
    w = wcsutils.SIPWCS.from_header(cards, zero_based=True)
    first = float(w.pix2world(-1.0, -1.0)[1])
    if where.startswith("equator"):  # the field straddles dec 0
        last = float(w.pix2world(float(n), float(n))[1])
        assert first * last < 0 and abs(first) < 2e-4
        assert (first > 0) == (where == "equator_n")
    got = wcsutils.pixelarea(w, N=n, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert got.shape == (n, n)
    jw = jwcsutils.SIPWCS.from_header(cards, zero_based=True)
    assert _rel(got.numpy(), jwcsutils.pixelarea(jw, N=n)) < RTOL
    # without a device: the same numbers, as numpy
    host = wcsutils.pixelarea(w, N=n)
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, got.numpy())
    # the float32 factor from the sidecar is the frozen copy's, bit for bit
    sidecar = tmp_path / "wcshead.txt"
    wcsarea.write_sidecar(sidecar, cards)
    factor = l1_to_l2.area_factor_from_config({"FITSWCS": str(sidecar)}, n, device="cpu")
    assert isinstance(factor, torch.Tensor) and factor.dtype == torch.float32
    np.testing.assert_array_equal(factor.numpy(), wcsarea.area_factor(cards, n, "cpu"))
    assert _rel(factor.numpy(), (got / pars.Omega_ideal).numpy()) < 6e-8


@pytest.mark.parametrize("where", list(DECS))
def test_the_float32_arithmetic_misses_the_bound(where):
    """The same arithmetic in float32 (the benchmark's control) keeps none
    of the Jacobian's digits."""
    n = 64
    cards = _cards(n, where)
    w = wcsutils.SIPWCS.from_header(cards, zero_based=True)
    want = wcsutils.pixelarea(w, N=n) / pars.Omega_ideal
    low = wcs_entry.area_factor_lowered(cards, n, "cpu")
    assert low.dtype == np.float32
    assert _rel(low, want) > 1e-3


def test_pix2world_on_numpy_is_the_jax_packages():
    """The WCS body serves numpy and torch: on numpy arrays it is the JAX
    package's host code, value for value; on float64 tensors it gives
    the same coordinates to a few ulps."""
    cards = _cards(128, "south")
    w = wcsutils.SIPWCS.from_header(cards, zero_based=True)
    jw = jwcsutils.SIPWCS.from_header(cards, zero_based=True)
    x = np.array([-1.0, 0.0, 17.5, 63.0, 128.0])
    y = np.array([-1.0, 90.0, 3.25, 63.0, 128.0])
    for a, b in zip(w.pix2world(x, y), jw.pix2world(x, y)):
        np.testing.assert_array_equal(a, b)
    ra, dec = w.pix2sky(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(ra.numpy(), jw.pix2world(x, y)[0] * wcsutils.DEG, rtol=1e-15)
    np.testing.assert_allclose(dec.numpy(), jw.pix2world(x, y)[1] * wcsutils.DEG, rtol=1e-15)


@pytest.mark.parametrize("north", [False, True])
def test_pixelarea_tan_closed_form(north):
    """TAN: dOmega = |det CD| (rad^2) cos^3(c), c the distance from the axis."""
    n, s = 64, 0.11 / 3600.0
    cards = {"CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN", "CRPIX1": 32.5, "CRPIX2": 32.5,
             "CRVAL1": 37.0, "CRVAL2": 20.0 if north else -20.0, "CD1_1": s, "CD1_2": 0.0,
             "CD2_1": 0.0, "CD2_2": s, "LONPOLE": 215.0}
    w = wcsutils.SIPWCS.from_header(cards)
    area = wcsutils.pixelarea(w, N=n, device="cpu").numpy()
    xx, yy = np.meshgrid(np.arange(n), np.arange(n))
    c = np.arctan(np.hypot((xx - w.crpix[0]) * s, (yy - w.crpix[1]) * s) * wcsutils.DEG)
    assert _rel(area, (s * wcsutils.DEG) ** 2 * np.cos(c) ** 3) < 2e-4


def test_pixelarea_stg_closed_form():
    """STG: dOmega = |det CD| (rad^2) cos^4(c/2)."""
    n, s = 64, 1.0 / 3600.0
    cards = {"CTYPE1": "RA---STG", "CTYPE2": "DEC--STG", "CRPIX1": 32.5, "CRPIX2": 32.5,
             "CRVAL1": 37.0, "CRVAL2": -20.0, "CD1_1": s, "CD1_2": 0.0, "CD2_1": 0.0,
             "CD2_2": s, "LONPOLE": 215.0}
    w = wcsutils.SIPWCS.from_header(cards)
    area = wcsutils.pixelarea(w, N=n, device="cpu").numpy()
    xx, yy = np.meshgrid(np.arange(n), np.arange(n))
    c = 2 * np.arctan(np.hypot((xx - w.crpix[0]) * s, (yy - w.crpix[1]) * s)
                      * wcsutils.DEG / 2.0)
    assert _rel(area, (s * wcsutils.DEG) ** 2 * np.cos(c / 2.0) ** 4) < 2e-4


N = 64
RP = synth.READ_PATTERN_DEFAULT


@pytest.fixture(scope="module")
def exposure(tmp_path_factory):
    """A 64^2 CALDIR, L1 tree and WCS sidecar."""
    d = tmp_path_factory.mktemp("wcsarea")
    caldir = synth.make_cal_files(str(d / "cal"), RP, nside=N, seed=5)
    cal = synth.synth_cal_arrays(N, RP, seed=5)
    synth.write_l1_file(str(d / "L1.asdf"),
                        synth.synth_l1_cube(cal, RP, rate_dn_s=10, nborder=4), RP,
                        amp33=synth.synth_amp33(N, len(RP), 4))
    sidecar = d / "L1_asdf_wcshead.txt"
    wcsarea.write_sidecar(sidecar, _cards(N, "south"))
    config = {"IN": str(d / "L1.asdf"), "CALDIR": caldir, "FITSWCS": str(sidecar),
              "SKYORDER": 2, "SLICEOUT": True}
    return config, calfiles.load_caldir(caldir), asdf_lite.open(config["IN"])["roman"]


def _recorded(fn):
    """(result, the recorder's counters and spans) of ``fn()`` under a profiler."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    snap = profiling.snapshot()
    profiling.reset()
    return out, snap["counters"], snap["spans"]


def test_prepare_inputs_takes_a_map_on_the_device_as_it_is(exposure):
    """A map made on the call's device is not staged: the call sends
    exactly a host map's bytes fewer, and the core reads that tensor."""
    config, pack, l1 = exposure
    area = l1_to_l2.area_factor_from_config(config, N, device="cpu")
    host = area.numpy().copy()
    l1_to_l2.prepare_inputs(l1, config, pack, host, device="cpu")  # the pack staged
    prep_t, c_t, _ = _recorded(lambda: l1_to_l2.prepare_inputs(l1, config, pack, area,
                                                                device="cpu"))
    prep_h, c_h, _ = _recorded(lambda: l1_to_l2.prepare_inputs(l1, config, pack, host,
                                                                device="cpu"))
    assert prep_t["arr"]["area_factor"] is area
    assert c_h["h2d_bytes"] - c_t["h2d_bytes"] == host.nbytes
    np.testing.assert_array_equal(prep_h["arr"]["area_factor"].numpy(), host)


def test_calibrateimage_makes_the_map_on_its_device(exposure, tmp_path):
    """``calibrateimage``'s L2 is ``calibrate_tree``'s with the host map."""
    config, pack, l1 = exposure
    cfg = dict(config, OUT=str(tmp_path / "L2.asdf"))
    _, counters, spans = _recorded(lambda: l1_to_l2.calibrateimage(cfg, device="cpu"))
    assert counters["area_host"] == 1 and "area_device" not in counters
    assert spans["host.area"]["count"] == spans["l1_to_l2.area"]["count"] == 1
    got = asdf_lite.open(cfg["OUT"])["roman"]
    host = l1_to_l2.area_factor_from_config(config, N)
    tree, _ = l1_to_l2.calibrate_tree(l1, config, pack, host, device="cpu")
    for k in ("data", "dq", "err", "data_withsky"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(tree["roman"][k]), k)


def test_area_counters_count_each_map(exposure):
    """``area_host`` counts each map made on the host, with or without a
    device argument; no sidecar makes no map and counts nothing."""
    config, _, _ = exposure
    nowcs = {k: v for k, v in config.items() if k != "FITSWCS"}

    def three():
        maps = [l1_to_l2.area_factor_from_config(config, N),
                l1_to_l2.area_factor_from_config(config, N, device="cpu"),
                l1_to_l2.area_factor_from_config(config, N, device=torch.device("cpu"))]
        ones = [l1_to_l2.area_factor_from_config(nowcs, N),
                l1_to_l2.area_factor_from_config(nowcs, N, device="cpu")]
        return maps, ones

    (maps, ones), counters, spans = _recorded(three)
    assert {k: v for k, v in counters.items() if k.startswith("area_")} == {"area_host": 3}
    assert spans["host.area"]["count"] == 5 and spans["l1_to_l2.area"]["count"] == 3
    assert isinstance(maps[0], np.ndarray) and maps[0].dtype == np.float32
    for m in maps[1:]:
        np.testing.assert_array_equal(m.numpy(), maps[0])
    assert isinstance(ones[0], np.ndarray) and (ones[0] == 1).all()
    assert ones[1].dtype == torch.float32 and bool((ones[1] == 1).all())
