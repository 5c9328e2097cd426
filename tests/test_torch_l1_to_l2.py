"""The whole L1 -> L2 slice: the port against the JAX package.

The JAX simulator writes one 128^2 L1 (and an EXTRACT_REF variant) and
its CALDIR, as in ``tests/test_run_all.py``; both packages'
``calibrateimage`` calibrate them (the port on ``device="cpu"``, its
plain path) and the L2 trees are compared, per variant:

- ``dq``: bit-exact, except that JUMP_DET may differ on at most 1e-4 of
  the pixels (a pixel within an ulp of its jump threshold, ``rsqrt``);
- ``data``, ``data_withsky``, ``err``, ``var_poisson``, ``var_rnoise``:
  rtol 1e-5 and atol 1e-5 max|ref| (float32 sums in another order);
- ``skycoefs`` and ``medsky``: rtol 1e-4 (a small least-squares solve
  on block medians);
- ``endslice``: exact;
- ``dumo`` and ``chisq`` (the likelihood variants, ``romancal_ramp_fit:
  True``): float16 in both trees and compared after the cast: within
  one float16 ulp plus the maps' atol (1e-5 max|ref|) on at least 99.9%
  of the pixels.  The atol is needed because both are differences of
  nearly equal float32 numbers (``dumo`` of two resultants, ``chisq`` of
  two quadratic forms), so near zero their float32 error exceeds a
  float16 ulp; the share allows for a pixel on a u-bin edge of the
  adaptive weights.  Measured on this fixture: ``dumo`` 0 pixels
  outside, ``chisq`` 7.6e-4 of the pixels (stars, where the chi-square
  is a small difference of two large forms).

One more test runs the port's core with the slab IPC route's plain twin
(``cfg["ipc"] = "slab-plain"``: ``(3y - 3Ky) + K Ky`` with the taps in
order) against the default route (the Neumann recursion, centre tap
first) and holds the post-IPC science maps to the same tolerances.

The product maps (``l1_to_l2.product_maps``: ``err``, the two variances,
float16 ``dumo`` / ``chisq``) are held bit for bit to the host numpy
packaging (``tests/map_cases.py``), one op at a time and in the trees.
"""

import map_cases
import numpy as np
import pytest
import torch

from romanimpreprocess_tpu.io import asdf_lite as jasdf
from romanimpreprocess_tpu.pipeline import l1_to_l2 as jl1_to_l2
from romanimpreprocess_tpu.pipeline import sim_to_l1
from romanimpreprocess_tpu.synth import make_cal_files, make_scene_file
from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles, staging
from romanimpreprocess_tpu_torch.ops import ipc_slab
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2

torch.set_num_threads(1)

READ_PATTERN = [[0], [1, 2], [3, 4, 5], [6, 7, 8, 9, 10], [11, 12], [13]]
N = 128
JUMP_DET = 4
MAPS = ("data", "data_withsky", "err", "var_poisson", "var_rnoise")
VARIANTS = {
    "base": (False, {}),
    "noexcl": (False, {"EXCLUDE_FIRST": False}),
    "extract_ref": (True, {"EXCLUDE_FIRST": False}),
    "skyorder_off": (False, {"SKYORDER": -1}),
    "skyorder_1_fitsout": (False, {"SKYORDER": 1, "FITSOUT": True}),
    "likely": (False, {"romancal_ramp_fit": True}),
    "likely_thresh": (False, {"romancal_ramp_fit": True,
                              "REJECTION_THRESHOLD": 5.0,
                              "correct_wfi18_transient": True}),
    "likely_kw": (False, {"romancal_ramp_fit": True,
                          "JUMP_KW": {"rejection_threshold": 1e4,
                                      "not_a_real_key": 1}}),
}
LIKELY = [k for k in VARIANTS if k.startswith("likely")]


def _reads():
    out = []
    for g in READ_PATTERN:
        out += [g[0], g[-1] + 1]
    return out


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_slice"))
    scene = make_scene_file(d + "/truth_F184_163_4.fits", nside_active=N - 8,
                            nstars=5)
    caldir = make_cal_files(d + "/roman_wfi", READ_PATTERN, nside=N, seed=5)
    c1 = {"IN": scene, "OUT": d + "/L1.asdf", "READS": _reads(),
          "CALDIR": caldir, "SEED": 200}
    sim_to_l1.run_config(c1)
    sim_to_l1.run_config(dict(c1, OUT=d + "/L1_xref.asdf",
                              EXTRACT_REF={"data_encoding_offset": 4000}))
    base = {"FITSWCS": d + "/L1_asdf_wcshead.txt", "CALDIR": caldir,
            "SKYORDER": 2, "SLICEOUT": True}
    out = {}
    for name, (xref, over) in VARIANTS.items():
        cin = d + ("/L1_xref.asdf" if xref else "/L1.asdf")
        cj = dict(base, IN=cin, OUT=d + f"/L2_{name}_jax.asdf", **over)
        ct = dict(base, IN=cin, OUT=d + f"/L2_{name}_torch.asdf", **over)
        jl1_to_l2.calibrateimage(cj)
        l1_to_l2.calibrateimage(ct, device="cpu")
        out[name] = (jasdf.open(cj["OUT"]), asdf_lite.open(ct["OUT"]), ct)
    return out


@pytest.mark.parametrize("name", list(VARIANTS))
def test_dq_bit_exact_but_bounded_jumps(pairs, name):
    ref, got, _ = pairs[name]
    dr, dg = np.asarray(ref["roman"]["dq"]), np.asarray(got["roman"]["dq"])
    assert dg.dtype == np.uint32 and dg.shape == dr.shape == (N - 8, N - 8)
    diff = dr ^ dg
    assert not (diff & ~np.uint32(JUMP_DET)).any()
    assert (diff != 0).mean() <= 1e-4
    assert (dr != 0).any()
    for side in ("left", "right", "top", "bottom"):
        k = f"dq_border_ref_pix_{side}"
        np.testing.assert_array_equal(got["roman"][k], ref["roman"][k])


@pytest.mark.parametrize("name", list(VARIANTS))
def test_science_and_variance_maps(pairs, name):
    ref, got, _ = pairs[name]
    jump_diff = (np.asarray(ref["roman"]["dq"]) ^ np.asarray(got["roman"]["dq"])) != 0
    for k in MAPS:
        r, g = np.asarray(ref["roman"][k]), np.asarray(got["roman"][k])
        assert g.dtype == r.dtype == np.float32 and g.shape == r.shape, k
        assert np.isfinite(g).all(), k
        ok = np.abs(g - r) <= 1e-5 * np.abs(r) + 1e-5 * np.abs(r).max()
        assert (ok | jump_diff).all(), (k, np.abs(g - r).max())


@pytest.mark.parametrize("name", list(VARIANTS))
def test_sky(pairs, name):
    ref, got, cfg = pairs[name]
    pr, pg = ref["processinfo"], got["processinfo"]
    sr, sg = np.asarray(pr["skycoefs"]), np.asarray(pg["skycoefs"])
    order = cfg["SKYORDER"]
    assert sg.shape == sr.shape == ((order + 1) * (order + 2) // 2 if order >= 0 else 0,)
    if sr.size:
        np.testing.assert_allclose(sg, sr, rtol=1e-4, atol=1e-4 * np.abs(sr).max())
    np.testing.assert_allclose(pg["medsky"], pr["medsky"], rtol=1e-4)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_endslice_and_metadata(pairs, name):
    ref, got, cfg = pairs[name]
    pr, pg = ref["processinfo"], got["processinfo"]
    np.testing.assert_array_equal(np.asarray(pg["endslice"]), np.asarray(pr["endslice"]))
    assert np.asarray(pg["endslice"]).dtype == np.int8
    np.testing.assert_array_equal(np.asarray(pg["weights"]), np.asarray(pr["weights"]))
    assert pg["exclude_first"] == pr["exclude_first"]
    assert set(got["roman"]) == set(ref["roman"])
    assert got["roman"]["meta"]["cal_step"] == ref["roman"]["meta"]["cal_step"]
    assert got["roman"]["meta"]["wcsinfo"] == ref["roman"]["meta"]["wcsinfo"]
    if cfg.get("FITSOUT"):
        from romanimpreprocess_tpu_torch.io import fits_lite

        hdus = fits_lite.open_fits(cfg["OUT"][:-5] + "_asdf_to.fits")
        np.testing.assert_array_equal(hdus[0].data, got["roman"]["data"])


@pytest.mark.parametrize("name", LIKELY)
@pytest.mark.parametrize("key", ["dumo", "chisq"])
def test_likelihood_diagnostics(pairs, name, key):
    ref, got, _ = pairs[name]
    r, g = np.asarray(ref["roman"][key]), np.asarray(got["roman"][key])
    assert g.dtype == r.dtype == np.float16 and g.shape == r.shape == (N - 8, N - 8)
    assert np.isfinite(g.astype(np.float32)).all()
    ulp = np.spacing(np.maximum(np.abs(r), np.abs(g))).astype(np.float32)
    r32, g32 = r.astype(np.float32), g.astype(np.float32)
    ok = np.abs(g32 - r32) <= ulp + 1e-5 * np.abs(r32).max()
    assert ok.mean() >= 0.999, (key, 1 - ok.mean())
    assert (r != 0).mean() > 0.9


def test_likelihood_variants_differ_as_configured(pairs):
    jump = lambda name: int((np.asarray(pairs[name][1]["roman"]["dq"]) & JUMP_DET != 0).sum())
    # a huge rejection threshold inside JUMP_KW suppresses jump flags
    assert jump("likely_kw") < jump("likely_thresh") <= jump("likely")
    log = str(pairs["likely_kw"][1]["processinfo"]["log"])
    assert "not_a_real_key" in log and "likelihood (adaptive-weight) ramp fit" in log
    assert pairs["likely_thresh"][1]["roman"]["meta"]["cal_step"]["wfi18_transient"] == "N/A"
    # the classic fit's tree carries the schema's all-zero placeholders
    assert not np.asarray(pairs["base"][1]["roman"]["dumo"]).any()


def test_slab_ipc_route_matches_default_route(pairs):
    """The slab route's twin through the whole core, against the default
    route (the frame kernel's twin): another order of summation, the
    same maps to the slice tolerances."""
    _, _, cfg = pairs["likely"]
    pack = calfiles.load_caldir_cached(cfg["CALDIR"])
    l1 = asdf_lite.open(cfg["IN"])["roman"]
    area = l1_to_l2.area_factor_from_config(cfg, pack.nside)
    keys = l1_to_l2.PRODUCT_OUTPUTS + ("dumo", "chisq")
    outs = {}
    for route in ("xla", "slab-plain", "slab"):
        prep = l1_to_l2.prepare_inputs(l1, cfg, pack, area, device="cpu")
        assert prep["cfg"]["ipc"] == "xla" and "ipc_kernel_padded" not in prep["arr"]
        prep["cfg"]["ipc"] = route
        prep["arr"]["ipc_kernel_padded"] = staging.stage(
            ipc_slab.kernel_planes_padded(pack.ipc_kernel, th=l1_to_l2.SLAB_TH), "cpu")
        core = l1_to_l2.make_core(prep["plan"], prep["cfg"], prep["geom"])
        outs[route] = staging.to_host(core(prep["arr"]))
        assert set(outs[route]) == set(keys)
    ref, got = outs["xla"], outs["slab-plain"]
    jump_diff = (ref["pdq"] ^ got["pdq"]) != 0
    assert not ((ref["pdq"] ^ got["pdq"]) & ~np.uint32(JUMP_DET)).any()
    assert jump_diff.mean() <= 1e-4
    for k in ("slope", "slope_withsky", "slope_err_read", "slope_err_poisson", "dumo"):
        r, g = ref[k], got[k]
        ok = np.abs(g - r) <= 1e-5 * np.abs(r) + 1e-5 * np.abs(r).max()
        assert (ok | jump_diff).all(), (k, np.abs(g - r).max())
    assert not np.array_equal(ref["slope"], got["slope"])  # the routes do differ
    np.testing.assert_allclose(got["skycoefs"], ref["skycoefs"], rtol=1e-4,
                               atol=1e-4 * np.abs(ref["skycoefs"]).max())
    # on a CPU tensor the kernel route's wrapper takes the same twin
    for k in keys:
        np.testing.assert_array_equal(outs["slab"][k], got[k], err_msg=k)


def test_return_arrays_and_core_outputs(pairs, tmp_path):
    _, _, cfg = pairs["base"]
    out = l1_to_l2.calibrateimage(dict(cfg, OUT=str(tmp_path / "L2.asdf")),
                                  device="cpu", return_arrays=True)
    assert set(out) == set(l1_to_l2.PRODUCT_OUTPUTS)
    assert out["pdq"].dtype == np.uint32 and out["endslice"].dtype == np.int8


@pytest.mark.parametrize("likely", [False, True])
def test_product_maps_match_numpy_bit_for_bit(likely):
    """``product_maps`` on CPU tensors against the host numpy packaging,
    every bit, NaN payloads included: random values and the edges of
    ``hypot`` and of the float16 cast; cropped and contiguous."""
    out = map_cases.inputs(n=512, nb=4)
    if not likely:
        del out["dumo"], out["chisq"]
    got = l1_to_l2.product_maps({k: torch.from_numpy(v) for k, v in out.items()}, 4)
    ref = map_cases.numpy_maps(out, 4)
    assert set(got) == set(ref) == {"err", "var_poisson", "var_rnoise"} | (
        {"dumo", "chisq"} if likely else set())
    for k, r in ref.items():
        g = got[k]
        assert g.is_contiguous() and g.numpy().dtype == r.dtype and g.shape == r.shape, k
        np.testing.assert_array_equal(map_cases.bits(g.numpy()), map_cases.bits(r), err_msg=k)
    # the edges reach the maps: hypot(inf, nan) is inf, NaN stays NaN
    assert np.isposinf(ref["err"][0, :4]).all() and np.isnan(ref["err"][0, 5])
    if likely:
        assert np.isinf(ref["dumo"][1, 2:5]).all() and (ref["dumo"][1, 13] == 0)


def _same_tree(a, b, path="tree"):
    """Two L2 trees field by field: the same keys in the same order,
    arrays of the same dtype, shape and bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(map_cases.bits(a), map_cases.bits(b), err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("name", ["base", "likely"])
def test_calibrate_tree_maps_are_the_host_packaging(pairs, name):
    """``calibrate_tree``'s maps, made beside the core, against the host
    numpy packaging of its own ``out`` bit for bit, and its tree field by
    field against ``package_tree`` given ``out`` alone (the maps made from
    the host arrays); ``out`` keeps the core's keys."""
    _, _, cfg = pairs[name]
    pack = calfiles.load_caldir_cached(cfg["CALDIR"])
    l1 = asdf_lite.open(cfg["IN"])["roman"]
    area = l1_to_l2.area_factor_from_config(cfg, pack.nside)
    tree, out = l1_to_l2.calibrate_tree(l1, cfg, pack, area, device="cpu")
    likely = ("dumo", "chisq") if name == "likely" else ()
    assert set(out) == set(l1_to_l2.PRODUCT_OUTPUTS + likely)
    nb = tree["processinfo"]["meta"]["nborder"]
    ref = map_cases.numpy_maps(out, nb)
    assert set(ref) == {"err", "var_poisson", "var_rnoise", *likely}
    for k, r in ref.items():
        np.testing.assert_array_equal(map_cases.bits(tree["roman"][k]), map_cases.bits(r),
                                      err_msg=k)
    assert ("dumo" in tree["roman"]) == bool(likely)
    prep = l1_to_l2.prepare_inputs(l1, cfg, pack, area, device="cpu")
    prep["log"] = tree["processinfo"]["log"]  # its timing line
    _same_tree(l1_to_l2.package_tree(out, prep, l1, cfg), tree)
