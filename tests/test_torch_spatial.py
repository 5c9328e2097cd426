"""Row-sharded (spatial) calibration of one SCA: the port on the CPU.

Mirrors ``tests/test_spatial.py`` case by case.  The port's row-sharded
core (``parallel.spatial``) on meshes of ``cpu`` entries, held to the
port's single-SCA core on the same bundle at ``_gate``'s tolerances
(``parity.row_shard_gate``): integer outputs (``pdq``, ``endslice``)
bit-exact; float outputs within ``max |got - ref| / (1 + |ref|)`` < 1e-4,
``chisq`` and ``dumo`` < 1e-3.  Then the port's row-sharded core against
the JAX package's on the conftest's 8 virtual CPU devices, at the
port-vs-JAX gate (``parity.compare_outputs(..., sky="derived")`` on the
active region) on a simulated 128^2 scene, and the IPC inverses'
row-slab twins (the frame route's and the slab routes') against their
whole-frame twins, bit for bit, at every cut of a 64^2 frame into 2 to
5 slabs.  64^2 and 128^2 frames.
"""

import numpy as np
import pytest
import torch

import jax

from romanimpreprocess_tpu.parallel import spatial as jspatial
from romanimpreprocess_tpu.pipeline import l1_to_l2 as jl1_to_l2
from romanimpreprocess_tpu_torch import benchlib, synth
from romanimpreprocess_tpu_torch.config import pattern_to_reads
from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles
from romanimpreprocess_tpu_torch.ops import ipc_cuda, ipc_slab
from romanimpreprocess_tpu_torch.parallel import spatial
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, sim_to_l1
from romanimpreprocess_tpu_torch.utils import parity
from romanimpreprocess_tpu_torch.utils.rows import Rows, split_rows

torch.set_num_threads(1)


def _gate(ref, out):
    return parity.row_shard_gate(ref, out, "row-sharded core")


def _run_pair(nside, n_devices, likelihood=False):
    arr, plan, cfg, geom = benchlib.core_bundle(nside=nside, likelihood=likelihood,
                                                device="cpu")
    ref = l1_to_l2.make_core(plan, cfg, geom)(arr)
    mesh = spatial.row_mesh(devices=["cpu"] * n_devices)
    core = spatial.make_spatial_calibrator(plan, cfg, geom, mesh)
    out = core(spatial.shard_rows(mesh, arr, geom))
    return ref, out


def test_row_sharded_core_matches_single_device(monkeypatch):
    calls = []
    real = l1_to_l2.calibrate_rows

    def counted(parts, *a):
        calls.append(len(parts))
        return real(parts, *a)

    # one source of the math: the single core and the row-sharded core
    # both run calibrate_rows, on one part and on eight
    monkeypatch.setattr(l1_to_l2, "calibrate_rows", counted)
    ref, out = _run_pair(nside=64, n_devices=8)
    assert calls == [1, 8]
    _gate(ref, spatial.gather_rows(out, "cpu"))
    # outputs stay per-entry row slabs (no implicit gather at the end)
    assert isinstance(out, spatial.RowShards) and len(out) == 8
    assert [o["slope"].shape[0] for o in out] == [8] * 8
    assert [(r.y0, r.n) for r in out.rows] == [(8 * i, 8) for i in range(8)]
    for o in out:
        assert torch.equal(o["skycoefs"], out[0]["skycoefs"])
        assert torch.equal(o["medsky"], out[0]["medsky"])


def test_row_sharding_survives_uneven_division():
    # 64 rows over 5 entries: slabs of 13 and 12 rows
    ref, out = _run_pair(nside=64, n_devices=5)
    assert [o["slope"].shape[0] for o in out] == [13, 13, 13, 13, 12]
    _gate(ref, spatial.gather_rows(out, "cpu"))


def test_row_sharded_likelihood_fitter():
    ref, out = _run_pair(nside=64, n_devices=8, likelihood=True)
    out = spatial.gather_rows(out, "cpu")
    assert {"dumo", "chisq"} <= set(out)
    _gate(ref, out)


def test_row_spec_classification():
    nside, nb = 64, 4
    assert spatial.row_spec(np.zeros((5, 64, 64)), nside, nb) == -2
    assert spatial.row_spec(np.zeros((5, 56, 56)), nside, nb) == -2
    assert spatial.row_spec(torch.zeros((64, 16)), nside, nb) == 0
    # metadata-scale arrays replicate
    assert spatial.row_spec(np.zeros((5,)), nside, nb) is None
    assert spatial.row_spec(np.float32(1.0), nside, nb) is None
    assert spatial.row_spec(torch.tensor(1.0), nside, nb) is None
    assert spatial.row_spec(np.zeros((3, 3)), nside, nb) is None


@pytest.mark.parametrize("n_devices", [2])
def test_row_sharded_dq_determinism(n_devices):
    # two identical sharded runs agree bit for bit
    arr, plan, cfg, geom = benchlib.core_bundle(nside=64, device="cpu")
    mesh = spatial.row_mesh(devices=["cpu"] * n_devices)
    core = spatial.make_spatial_calibrator(plan, cfg, geom, mesh)
    arrs = spatial.shard_rows(mesh, arr, geom)
    o1 = spatial.gather_rows(core(arrs), "cpu")
    o2 = spatial.gather_rows(core(arrs), "cpu")
    for k in o1:
        assert torch.equal(o1[k], o2[k]), k


N_SCENE = 128
RP_SCENE = [[0], [1, 2], [3, 4, 5], [6, 7, 8], [9, 10]]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 128^2 L1 simulated by the port from a star scene, its CALDIR and
    WCS sidecar, and the same L1 relabelled as WFI18."""
    d = str(tmp_path_factory.mktemp("tspatial"))
    scene = synth.make_scene_file(d + "/truth_F184_163_4.fits",
                                  nside_active=N_SCENE - 8, nstars=3)
    caldir = synth.make_cal_files(d + "/roman_wfi", RP_SCENE, nside=N_SCENE, seed=5)
    sim_to_l1.run_config({"IN": scene, "OUT": d + "/L1.asdf",
                          "READS": pattern_to_reads(RP_SCENE), "CALDIR": caldir,
                          "SEED": 200}, device="cpu")
    # relabel as WFI18 so the transient row fit runs
    f = asdf_lite.open(d + "/L1.asdf")
    tree = dict(f.tree)
    tree["roman"] = dict(tree["roman"])
    tree["roman"]["meta"] = dict(tree["roman"]["meta"])
    tree["roman"]["meta"]["instrument"] = dict(
        tree["roman"]["meta"]["instrument"], detector="WFI18")
    asdf_lite.AsdfFile(tree).write_to(d + "/L1_18.asdf")
    return {"L1": d + "/L1.asdf", "L1_18": d + "/L1_18.asdf", "CALDIR": caldir,
            "FITSWCS": d + "/L1_asdf_wcshead.txt"}


def _prepare(config):
    """``prepare_inputs`` of the port on the CPU for ``config``."""
    pack = calfiles.load_caldir_cached(config["CALDIR"])
    l1 = asdf_lite.open(config["IN"])["roman"]
    area = l1_to_l2.area_factor_from_config(config, pack.nside)
    return l1_to_l2.prepare_inputs(l1, config, pack, area, device="cpu")


def test_row_sharded_full_config_with_wfi18(scene):
    """Row sharding through a real config path (synth cal files, WFI18
    transient row fit, sky medfit, SLICEOUT endslice) at 128^2: the
    global row regression and block-median stages over 8 slabs."""
    config = {"IN": scene["L1_18"], "FITSWCS": scene["FITSWCS"],
              "CALDIR": scene["CALDIR"], "SKYORDER": 2, "SLICEOUT": True,
              "correct_wfi18_transient": True}
    prep = _prepare(config)
    assert prep["cfg"]["wfi18"] and prep["cfg"]["use_amp33"]
    ref = l1_to_l2.make_core(prep["plan"], prep["cfg"], prep["geom"])(prep["arr"])

    mesh = spatial.row_mesh(devices=["cpu"] * 8)
    core = spatial.make_spatial_calibrator(prep["plan"], prep["cfg"], prep["geom"], mesh)
    _gate(ref, spatial.gather_rows(
        core(spatial.shard_rows(mesh, prep["arr"], prep["geom"])), "cpu"))


def test_sca_row_2d_mesh_batched_core():
    """2-D (SCA x row) mesh: two SCAs, each row-sharded over 4 entries;
    per-lane results against the single core."""
    arr1, plan, cfg, geom = benchlib.core_bundle(nside=64, seed=1000, device="cpu")
    arr2, _, _, _ = benchlib.core_bundle(nside=64, seed=2000, device="cpu")
    core = l1_to_l2.make_core(plan, cfg, geom)
    refs = [core(a) for a in (arr1, arr2)]

    mesh = spatial.sca_row_mesh(2, 4, devices=["cpu"] * 8)
    assert len(mesh) == 2 and all(len(m) == 4 for m in mesh)
    batch = {k: torch.stack([arr1[k], arr2[k]]) for k in arr1}
    lanes = spatial.shard_batch_rows(mesh, batch, geom)
    outs = spatial.make_spatial_calibrator(plan, cfg, geom, mesh)(lanes)
    assert len(outs) == 2
    for ref, out in zip(refs, spatial.gather_rows(outs, "cpu")):
        _gate(ref, out)
    assert not torch.equal(refs[0]["slope"], refs[1]["slope"])


def test_mesh_and_route_errors():
    arr, plan, cfg, geom = benchlib.core_bundle(nside=64, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spatial.row_mesh()
    with pytest.raises(ValueError, match="needs 8 entries"):
        spatial.sca_row_mesh(2, 4, devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="cannot cut"):
        split_rows(4, 5, spatial.HALO)


@pytest.mark.parametrize("likelihood", [False, True])
def test_row_sharded_slab_ipc_route(likelihood):
    """The slab IPC routes' twin (``cfg["ipc"] = "slab-plain"``, what
    ``IPC_BACKEND: pallas`` / ``pallas-stream`` run on the card) through
    the row-sharded core on 5 entries, against the single core on the
    same route."""
    arr, plan, cfg, geom = benchlib.core_bundle(nside=64, likelihood=likelihood,
                                                device="cpu")
    cfg = dict(cfg, ipc="slab-plain")
    nb, na = geom[1], geom[0] - 2 * geom[1]
    kernel = arr["ipc_kernel_frame"][:, nb:-nb, nb:-nb].reshape(3, 3, na, na).numpy()
    arr = dict(arr, ipc_kernel_padded=torch.from_numpy(
        ipc_slab.kernel_planes_padded(kernel, th=l1_to_l2.SLAB_TH)))
    ref = l1_to_l2.make_core(plan, cfg, geom)(arr)
    mesh = spatial.row_mesh(devices=["cpu"] * 5)
    out = spatial.make_spatial_calibrator(plan, cfg, geom, mesh)(
        spatial.shard_rows(mesh, arr, geom))
    _gate(ref, spatial.gather_rows(out, "cpu"))


# --------------------------------------------------------------------------
# against the JAX package's row-sharded core
# --------------------------------------------------------------------------

L2_MAPS = ("data", "data_withsky", "err", "var_poisson", "var_rnoise")


def _l2_fields(out, nb):
    """Core outputs as the L2 product carries them (``package_tree``:
    the active region, ``err`` the hypot of the two errors, the
    variances their squares, ``pdq`` as uint32), under the names
    ``parity.compare_outputs`` reads."""
    a = slice(nb, -nb)
    o = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
         for k, v in out.items()}
    ser, sep = o["slope_err_read"][a, a], o["slope_err_poisson"][a, a]
    return {"data": o["slope"][a, a], "data_withsky": o["slope_withsky"][a, a],
            "err": np.hypot(ser, sep).astype(np.float32), "var_poisson": sep ** 2,
            "var_rnoise": ser ** 2, "pdq": o["pdq"][a, a].view(np.uint32),
            "skycoefs": o["skycoefs"], "medsky": o["medsky"], "endslice": o["endslice"]}


@pytest.mark.parametrize("likelihood", [False, True])
def test_row_sharded_core_against_jax(scene, likelihood):
    """The scene's L1 (WFI18, so the row fit runs) through each
    package's ``prepare_inputs`` and row-sharded core, the JAX one on the
    conftest's 8 virtual devices, the port's on 8 ``cpu`` entries: the
    port-vs-JAX gate of the slice on the fields of the L2 product
    (``compare_outputs(..., sky="derived")``, as for the focal plane's
    trees; with the likelihood fit ``dumo`` and
    ``chisq`` within one float16 ulp plus 1e-5 max|ref| on 99.9% of the
    pixels).  The scene, as the slice's L2 tests use: on
    ``benchlib.core_bundle``'s flat 1 DN/s ramps the two packages'
    single cores already round apart on most pixels by more than the
    maps' atol of 1e-5 max|ref| (XLA:CPU's fused multiply-add in the
    jitted reference, PERF.md section 6)."""
    from romanimpreprocess_tpu.io import asdf_lite as jasdf
    from romanimpreprocess_tpu.io import calfiles as jcalfiles

    config = {"IN": scene["L1_18"], "FITSWCS": scene["FITSWCS"],
              "CALDIR": scene["CALDIR"], "SKYORDER": 2, "SLICEOUT": True,
              "correct_wfi18_transient": True, "romancal_ramp_fit": likelihood}
    jpack = jcalfiles.load_caldir_cached(config["CALDIR"])
    jl1 = jasdf.open(config["IN"])["roman"]
    jprep = jl1_to_l2.prepare_inputs(
        jl1, config, jpack, jl1_to_l2.area_factor_from_config(config, jpack.nside))
    jmesh = jspatial.row_mesh(8)
    jcore = jspatial.make_spatial_calibrator(jprep["plan"], jprep["cfg"],
                                             jprep["geom"], jmesh)
    jout = jax.block_until_ready(jcore(jspatial.shard_rows(jmesh, jprep["arr"],
                                                           jprep["geom"])))
    jout = {k: np.asarray(v) for k, v in jout.items()}

    prep = _prepare(config)
    mesh = spatial.row_mesh(devices=["cpu"] * 8)
    core = spatial.make_spatial_calibrator(prep["plan"], prep["cfg"], prep["geom"], mesh)
    got = spatial.gather_rows(core(spatial.shard_rows(mesh, prep["arr"], prep["geom"])),
                              "cpu")
    nb = prep["geom"][1]
    rep = parity.compare_outputs(_l2_fields(jout, nb), _l2_fields(got, nb),
                                 "spatial vs JAX", maps=L2_MAPS, sky="derived")
    assert rep["skycoefs_within_gate"] and rep["medsky_within_gate"]
    if likelihood:
        for k in ("dumo", "chisq"):
            r = jout[k][nb:-nb, nb:-nb].astype(np.float16)
            g = got[k].numpy()[nb:-nb, nb:-nb].astype(np.float16)
            ulp = np.spacing(np.maximum(np.abs(r), np.abs(g))).astype(np.float32)
            r32, g32 = r.astype(np.float32), g.astype(np.float32)
            ok = np.abs(g32 - r32) <= ulp + 1e-5 * np.abs(r32).max()
            assert ok.mean() >= 0.999, (k, 1 - ok.mean())


# --------------------------------------------------------------------------
# the IPC inverse's row-slab form
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nside,nb", [(20, 4), (13, 0), (9, 2)])
def test_rows_geometry_matches_the_active_mask(nside, nb):
    """``Rows.active`` / ``own_active`` / ``active_span`` / ``trimmed``
    against the frame's active-row mask, for every slab and halo up to 2
    rows (slabs in the border, across it and inside the active rows)."""
    active = np.zeros(nside, bool)
    active[nb : nside - nb] = True
    for y0 in range(nside):
        for n in range(1, nside - y0 + 1):
            for lo in range(3):
                for hi in range(3 - (lo + 3 > n)):
                    if lo + hi >= n:
                        continue
                    r = Rows(y0, n, lo, hi).checked(nside, nb)
                    rows = np.arange(y0, y0 + n)
                    assert list(rows[r.active(nside, nb)]) == list(rows[active[rows]])
                    own = rows[r.own]
                    assert list(rows[r.own_active(nside, nb)]) == list(own[active[own]])
                    span = r.active_span(nside, nb)
                    assert list(range(span.start, span.stop)) == list(rows[active[rows]] - nb)
                    t = r.trimmed()
                    assert list(range(t.y0, t.y0 + t.n)) == list(own) and t.lo == t.hi == 0
    with pytest.raises(ValueError, match="no own rows"):
        Rows(0, 4, 2, 2).checked(nside, nb)
    cut = split_rows(nside, 3, 2)
    assert [y for r in cut for y in range(r.y0 + r.lo, r.y0 + r.n - r.hi)] == list(range(nside))


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_ipc_rows_plain_matches_frame_plain(n):
    """``ipc_rev2_rows_plain`` on the slabs of ``split_rows`` (the least
    halo, ``ipc_slab.NEUMANN_EXT``, and :data:`spatial.HALO`) gives the
    frame twin's output bit for bit, a NaN and infinities in the border
    rows and columns read included."""
    from romanimpreprocess_tpu_torch.utils import time_frame

    gen = torch.Generator().manual_seed(n)
    for nonfinite in (False, True):
        data, planes, gain = time_frame.inputs(3, 64, 4, gen, nonfinite)
        ref = ipc_cuda.ipc_rev2_frame_plain(data, planes, gain, 4)
        parts = [ipc_cuda.ipc_rev2_rows(d, p, g, 4, row0, lo, hi)
                 for d, p, g, row0, lo, hi in time_frame.slabs(data, planes, gain, n)]
        assert time_frame.same_bits(torch.cat(parts, dim=1), ref)
        cut = [(slice(r.y0, r.y0 + r.n), r) for r in split_rows(64, n, spatial.HALO)]
        parts = [ipc_cuda.ipc_rev2_rows(data[:, y], planes[:, y], gain[y], 4, r.y0, r.lo, r.hi)
                 for y, r in cut]
        assert time_frame.same_bits(torch.cat(parts, dim=1), ref)
        res = time_frame.check_rows(3, 64, 4, n, gen, nonfinite)
        assert res["bit_exact"] and res["max_abs_err"] == 0.0


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_slab_route_rows_plain_matches_frame_plain(n):
    """``ipc_slab.correct_cube_plain`` (the slab routes' twin) on the
    slabs of ``split_rows`` gives its own output on the whole frame bit
    for bit, with the raw and the pre-padded kernel."""
    from romanimpreprocess_tpu_torch.utils import time_frame

    gen = torch.Generator().manual_seed(10 + n)
    data, planes, gain = time_frame.inputs(3, 64, 4, gen)
    K = planes[:, 4:-4, 4:-4].reshape(3, 3, 56, 56)
    for kernel, th in ((K, 8), (torch.from_numpy(ipc_slab.kernel_planes_padded(
            K.numpy(), th=32)), 32)):
        ref = ipc_slab.correct_cube_plain(data, kernel, gain[4:-4, 4:-4], 4, th)
        parts = [ipc_slab.correct_cube_plain(
                     d, kernel, g[Rows(row0, d.shape[1], lo, hi).active(64, 4), 4:-4], 4,
                     th, row0, lo, hi)
                 for d, _, g, row0, lo, hi in time_frame.slabs(data, planes, gain, n)]
        assert time_frame.same_bits(torch.cat(parts, dim=1), ref)
