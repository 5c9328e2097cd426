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
- ``endslice``: exact.
"""

import numpy as np
import pytest
import torch

from romanimpreprocess_tpu.io import asdf_lite as jasdf
from romanimpreprocess_tpu.pipeline import l1_to_l2 as jl1_to_l2
from romanimpreprocess_tpu.pipeline import sim_to_l1
from romanimpreprocess_tpu.synth import make_cal_files, make_scene_file
from romanimpreprocess_tpu_torch.io import asdf_lite
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
}


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


def test_return_arrays_and_core_outputs(pairs, tmp_path):
    _, _, cfg = pairs["base"]
    out = l1_to_l2.calibrateimage(dict(cfg, OUT=str(tmp_path / "L2.asdf")),
                                  device="cpu", return_arrays=True)
    assert set(out) == set(l1_to_l2.PRODUCT_OUTPUTS)
    assert out["pdq"].dtype == np.uint32 and out["endslice"].dtype == np.int8
