"""The port's focal-plane layer against itself and the JAX package, on the CPU.

``parallel.calibrate_fpa`` on a two-entry CPU mesh (``["cpu", "cpu"]``:
two workers on one device) over three SCAs (two cal sets, two MA
tables): each tree is the port's ``calibrateimage`` tree bit for bit (its
log's ``Timing:`` line aside), and meets the slice's gates
(``parity.compare_outputs``) against the JAX ``calibrate_fpa`` on the
conftest's virtual 2-device mesh.  The staged runners with ``mesh=``:
lane ``i`` is the single-SCA runner at ``noise.lane_seed(seed, i)`` bit
for bit, lanes differ, the same seed repeats; each layer of the port's
lanes meets ``parity.compare_noise`` against the JAX
``make_fpa_exposure_runner``'s lanes.  ``benchlib``'s bundles against the
JAX package's, array for array (the IPC kernel forms are each package's
own).  128^2 frames.
"""

import numpy as np
import pytest
import torch

import jax

from romanimpreprocess_tpu import benchlib as jbenchlib
from romanimpreprocess_tpu import parallel as jparallel
from romanimpreprocess_tpu.io import asdf_lite as jasdf
from romanimpreprocess_tpu_torch import benchlib, parallel, synth
from romanimpreprocess_tpu_torch.config import pattern_to_reads
from romanimpreprocess_tpu_torch.io import asdf_lite, staging
from romanimpreprocess_tpu_torch.parallel import spatial
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, noise, noise_core, sim_to_l1
from romanimpreprocess_tpu_torch.utils import parity

torch.set_num_threads(1)

READ_PATTERN = [[0], [1, 2], [3, 4, 5], [6, 7, 8], [9, 10]]
RP_B = [[0], [1, 2], [3, 4], [5, 6]]
N = 128
NA = N - 8
LAYERS = ["Rz4S2", "O", "PbrS2"]  # tests/test_fpa_exposure.py
MESH = ("cpu", "cpu")
L2_MAPS = ("data", "data_withsky", "err", "var_poisson", "var_rnoise")


def _l2_outputs(tree):
    """An L2 tree's fields under the names ``parity.compare_outputs`` reads."""
    im, pi = tree["roman"], tree["processinfo"]
    out = {k: np.asarray(im[k]) for k in L2_MAPS}
    out.update(pdq=np.asarray(im["dq"]), skycoefs=np.asarray(pi["skycoefs"]),
               medsky=np.asarray(pi["medsky"]), endslice=np.asarray(pi["endslice"]))
    return out


@pytest.fixture(scope="module")
def fpa(tmp_path_factory):
    """Three SCAs: 4 and 7 on cal set A (the 5-group table), 5 on cal set
    B (a 4-group table), simulated by the port; calibrated by the port's
    ``calibrate_fpa`` on the CPU mesh, its ``calibrateimage``, and the
    JAX ``calibrate_fpa``."""
    d = str(tmp_path_factory.mktemp("tfpa"))
    cals = {"A": synth.make_cal_files(d + "/calA", READ_PATTERN, nside=N, seed=4, sca=4),
            "B": synth.make_cal_files(d + "/calB", RP_B, nside=N, seed=5, sca=5)}
    configs, tables = [], []
    for sca, cal, rp in ((4, "A", READ_PATTERN), (5, "B", RP_B), (7, "A", READ_PATTERN)):
        scene = synth.make_scene_file(d + f"/truth_F184_163_{sca}.fits", nside_active=NA,
                                      nstars=3)
        sim_to_l1.run_config({"IN": scene, "OUT": d + f"/L1_{sca}.asdf",
                              "READS": pattern_to_reads(rp), "CALDIR": cals[cal],
                              "SEED": 70 + sca}, device="cpu")
        configs.append({"IN": d + f"/L1_{sca}.asdf", "OUT": d + f"/L2fpa_{sca}.asdf",
                        "FITSWCS": d + f"/L1_{sca}_asdf_wcshead.txt",
                        "CALDIR": cals[cal], "SKYORDER": 2, "SLICEOUT": True})
        tables.append(rp)
    mesh = parallel.sca_mesh(devices=MESH)
    trees, timings = parallel.calibrate_fpa(configs, mesh=mesh, profile=True)
    singles = []
    for sca, c in zip((4, 5, 7), configs):
        cs = dict(c, OUT=d + f"/L2single_{sca}.asdf")
        l1_to_l2.calibrateimage(cs, device="cpu")
        singles.append(asdf_lite.open(cs["OUT"]))
    jconfigs = [dict(c, OUT=c["OUT"][:-5] + "_jax.asdf") for c in configs]
    jtrees = jparallel.calibrate_fpa(jconfigs, mesh=jparallel.sca_mesh(2))
    return dict(d=d, configs=configs, tables=tables, trees=trees, timings=timings,
                singles=singles, jtrees=jtrees, jconfigs=jconfigs)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_calibrate_fpa_is_calibrateimage_bit_for_bit(fpa, i):
    c = fpa["configs"][i]
    written = asdf_lite.open(c["OUT"])
    single = fpa["singles"][i]
    sub = (c["OUT"], single.tree["processinfo"]["config"]["OUT"])
    parity.same_tree(written.tree, single.tree, f"SCA {i} file", subst=sub)
    tree = fpa["trees"][i]
    assert tree["roman"]["meta"]["exposure"]["read_pattern"] == fpa["tables"][i]
    for k in L2_MAPS + ("dq", "chisq", "dumo"):
        np.testing.assert_array_equal(np.asarray(tree["roman"][k]),
                                      np.asarray(single["roman"][k]), err_msg=k)
    assert "Timing:" in tree["processinfo"]["log"]


@pytest.mark.parametrize("i", [0, 1, 2])
def test_calibrate_fpa_against_jax(fpa, i):
    """The slice's gates on DQ, the maps and endslice; ``skycoefs`` and
    ``medsky`` within the bound the maps' measured difference puts on
    them (``sky="derived"``, ``parity.sky_bounds``).  On these faint-sky
    scenes (0.02-0.3 DN/s) the two packages' slopes differ in their
    float32 rounding on nearly every pixel, by up to about 2e-4 DN/s;
    the block medians inherit that, and a fixed linear map of them is
    the sky fit, so the coefficients may move by up to ``|A| @`` that
    (about 4e-4 here), more than the rtol 1e-4 of the largest
    coefficient that holds where the sky is bright."""
    ref = fpa["jtrees"][i]
    got = fpa["trees"][i]
    rep = parity.compare_outputs(_l2_outputs(ref), _l2_outputs(got), f"SCA {i}",
                                 maps=L2_MAPS, sky="derived")
    assert rep["skycoefs_within_gate"] and rep["medsky_within_gate"]
    assert set(jasdf.open(fpa["jconfigs"][i]["OUT"])["roman"]) == set(
        asdf_lite.open(fpa["configs"][i]["OUT"])["roman"])


def test_calibrate_fpa_prefetch_gives_the_same_trees(fpa):
    """Two SCAs staged ahead on each entry (``prefetch=2``), without
    writing: the same trees."""
    mesh = parallel.sca_mesh(devices=MESH)
    trees = parallel.calibrate_fpa(fpa["configs"], mesh=mesh, write=False, prefetch=2)
    for got, want in zip(trees, fpa["trees"]):
        for k in L2_MAPS + ("dq",):
            np.testing.assert_array_equal(got["roman"][k], want["roman"][k], err_msg=k)
        assert "chisq" not in got["roman"]  # typefix runs only on the write path


def test_calibrate_fpa_timings(fpa):
    t = fpa["timings"]
    assert [g["n_sca"] for g in t["groups"]] == [2, 1]
    assert all(g["pad"] == 0 and g["compute_s"] > 0 for g in t["groups"])
    assert t["config_groups"] == 2
    for k in ("host_staging_s", "package_s", "write_s", "total_s"):
        assert 0 <= t[k] <= t["total_s"], k
    assert "peak_mem_gb" not in t  # no CUDA device in the mesh


def test_mesh_entry_points_need_a_gpu_or_a_cpu_mesh():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.sca_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.calibrate_fpa([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchlib.core_bundle(nside=32)
    assert parallel.sca_mesh(devices=["cpu", "cpu"]) == (torch.device("cpu"),) * 2


# --------------------------------------------------------------------------
# the staged runners with mesh=
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundle():
    return benchlib.exposure_bundle(nside=N, device="cpu")


@pytest.fixture(scope="module")
def lanes(bundle):
    """The port's 3-lane exposure runner on the CPU mesh at seed 7, and
    the JAX runner's 4 lanes (``tests/test_fpa_exposure.py``)."""
    arr, prep, pack = bundle
    mesh = parallel.sca_mesh(devices=MESH)
    run_b = parallel.make_fpa_exposure_runner(prep, pack, LAYERS, mesh)
    batch = parallel.broadcast_batch(arr, 3)
    cube, base, checks = run_b(7, batch)
    jarr, jprep, jpack = jbenchlib.exposure_bundle(nside=N)
    jmesh = jparallel.sca_mesh(2)
    jrun = jparallel.make_fpa_exposure_runner(jprep, jpack, LAYERS, jmesh)
    jcube, jbase, _ = jrun(jax.random.key(7, impl="rbg"),
                           jparallel.shard_batch(jmesh, jparallel.broadcast_batch(jarr, 4)))
    return dict(run_b=run_b, batch=batch, cube=cube, base=base, checks=checks,
                jcube=np.asarray(jcube), jpdq=np.asarray(jbase["pdq"]))


def test_exposure_lanes_are_single_runs(bundle, lanes):
    arr, prep, pack = bundle
    cube, base, checks = lanes["cube"], lanes["base"], lanes["checks"]
    assert cube.shape == (3, len(LAYERS), NA, NA) and checks.shape == (3,)
    assert bool(torch.isfinite(cube).all())
    run_1 = noise_core.make_staged_exposure_runner(prep, pack, LAYERS)
    for i in range(3):
        c1, b1, k1 = run_1(noise.lane_seed(7, i), arr)
        assert torch.equal(cube[i], c1), i
        assert torch.equal(checks[i], k1), i
        for k in b1:
            assert torch.equal(base[k][i], b1[k]), (i, k)
    for i in range(3):
        for j in range(i + 1, 3):
            assert not torch.equal(cube[i], cube[j]), (i, j)


def test_exposure_lanes_repeat_per_seed(bundle, lanes):
    _arr, prep, pack = bundle
    again, _, _ = lanes["run_b"](7, lanes["batch"])
    other, _, _ = lanes["run_b"](8, lanes["batch"])
    assert torch.equal(again, lanes["cube"])
    assert not torch.equal(other, lanes["cube"])
    # a lane's streams do not depend on the number of lanes or entries
    one = parallel.make_fpa_exposure_runner(prep, pack, LAYERS,
                                            parallel.sca_mesh(devices=["cpu"]))
    c2, _, _ = one(7, {k: v[:2] for k, v in lanes["batch"].items()})
    assert torch.equal(c2, lanes["cube"][:2])


@pytest.mark.parametrize("i", [0, 1, 2])
def test_exposure_lanes_against_jax(lanes, i):
    good = lanes["jpdq"][0][4:-4, 4:-4] == 0
    parity.compare_noise(lanes["jcube"][i], lanes["cube"][i].numpy(), good, f"lane {i}")


def test_noise_runner_lanes_are_single_runs(bundle):
    _arr, prep, pack = bundle
    mesh = parallel.sca_mesh(devices=MESH)
    layers = ["Rz4S2", "O"]
    run_b = noise_core.make_staged_noise_runner(prep, pack, layers, mesh=mesh)
    lanes = parallel.shard_batch(mesh, parallel.broadcast_batch(prep["arr"], 2))
    # shared arrays: one placement per device (both entries are the CPU)
    assert lanes[0]["gain"] is lanes[1]["gain"]
    cube, _, checks = run_b(3, lanes)
    run_1 = noise_core.make_staged_noise_runner(prep, pack, layers)
    for i in range(2):
        c1, _, k1 = run_1(noise.lane_seed(3, i), prep["arr"])
        assert torch.equal(cube[i], c1) and torch.equal(checks[i], k1), i
    assert not torch.equal(cube[0], cube[1])


def test_lane_seed_streams():
    seeds = [noise.lane_seed(7, i) for i in range(18)]
    assert len(set(seeds)) == 18 and seeds == [noise.lane_seed(7, i) for i in range(18)]
    ss = np.random.SeedSequence(7, spawn_key=(noise.LANE_STREAMS, 5))
    assert seeds[5] == int(ss.generate_state(1, np.uint64)[0])
    assert noise.LANE_STREAMS not in (noise.LAYER_STREAMS, noise.SIM_STREAM,
                                      noise.FILL_STREAM)


def test_shard_batch_places_shared_arrays_once():
    mesh = parallel.sca_mesh(devices=MESH)
    shared = np.arange(12, dtype=np.float32).reshape(3, 4)
    own = np.stack([shared * k for k in range(3)])
    batch = parallel.broadcast_batch({"s": shared}, 3)
    batch["o"] = own
    assert batch["s"].strides[0] == 0
    batch["z"] = np.stack([np.float32(k) for k in range(3)])  # 0-d per lane
    lanes = parallel.shard_batch(mesh, batch)
    assert len(lanes) == 3 and lanes[2]["z"].shape == () and float(lanes[2]["z"]) == 2.0
    assert lanes[0]["s"] is lanes[1]["s"] is lanes[2]["s"]
    for k in range(3):
        assert torch.equal(lanes[k]["o"], torch.from_numpy(own[k]))
    t = torch.arange(5.0)
    tb = parallel.broadcast_batch({"t": t}, 4)["t"]
    assert tb.stride(0) == 0 and tb.shape == (4, 5)
    assert parallel.shard_batch(mesh, {"t": tb})[3]["t"].data_ptr() == t.data_ptr()
    # the lanes and the row slabs are placed by the one staging function
    assert parallel.place is spatial.place is staging.place


# --------------------------------------------------------------------------
# benchlib, fpa_summary, the calibrator
# --------------------------------------------------------------------------

IPC_FORMS = ("ipc_kernel", "ipc_kernel_padded", "ipc_kernel_frame")


def _host(v):
    a = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return a


def _same_values(got, want, what):
    got, want = _host(got), np.asarray(want)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)


@pytest.mark.parametrize("likelihood", [False, True])
def test_core_bundle_matches_jax(likelihood):
    arr, plan, cfg, geom = benchlib.core_bundle(nside=64, likelihood=likelihood,
                                                device="cpu")
    jarr, jplan, jcfg, jgeom = jbenchlib.core_bundle(nside=64, likelihood=likelihood)
    assert geom == jgeom
    assert "ipc_kernel_frame" in arr and cfg["ipc"] == "xla"
    for k in set(jarr) - set(IPC_FORMS):
        assert k in arr, k
        if k in ("dark_slope_ipc", "flat_ipc"):
            np.testing.assert_allclose(_host(arr[k]), np.asarray(jarr[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        else:
            _same_values(arr[k], jarr[k], k)
    for k in ("exclude_first", "backup", "use_amp33", "likelihood_fit", "has_ipc",
              "first_is_reset", "skyorder", "has_biascorr"):
        assert cfg[k] == jcfg[k], k
    np.testing.assert_array_equal(np.asarray(plan.W), np.asarray(jplan.W))


def test_exposure_bundle_matches_jax(bundle):
    arr, prep, pack = bundle
    jarr, jprep, jpack = jbenchlib.exposure_bundle(nside=N)
    assert "data" not in arr and arr["rate"].shape == (NA, NA)
    for k in set(arr) & (set(jarr) - set(IPC_FORMS) - {"dark_slope_ipc", "flat_ipc"}):
        _same_values(arr[k], jarr[k], k)
    for name, vj in vars(jpack).items():
        vt = getattr(pack, name)
        if isinstance(vj, np.ndarray):
            np.testing.assert_array_equal(vt, vj, err_msg=name)
        elif not isinstance(vj, dict):
            assert vt == vj, name
    assert prep["read_pattern"] == jprep["read_pattern"]
    np.testing.assert_array_equal(prep["weights_out"], jprep["weights_out"])


def test_fpa_summary_against_numpy():
    rng = np.random.default_rng(3)
    x = rng.normal(5.0, 2.0, (4, 32, 32)).astype(np.float32)
    mean, std = parallel.fpa_summary(parallel.sca_mesh(devices=MESH), torch.from_numpy(x))
    np.testing.assert_allclose(mean, x.mean(axis=(1, 2)), rtol=1e-5)
    np.testing.assert_allclose(std, x.std(axis=(1, 2)), rtol=1e-5)
    assert mean.dtype == np.float32 and mean.shape == (4,)


def test_fpa_calibrator_stacks_single_cores():
    arr, plan, cfg, geom = benchlib.core_bundle(nside=64, device="cpu")
    mesh = parallel.sca_mesh(devices=MESH)
    run = parallel.make_fpa_calibrator(plan, cfg, geom, mesh)
    batch = parallel.broadcast_batch(arr, 3)
    batch["data"] = torch.stack([arr["data"], arr["data"] + 50.0, arr["data"] + 100.0])
    out = run(batch)
    core = l1_to_l2.make_core(plan, cfg, geom)
    for i in range(3):
        one = core(dict(arr, data=batch["data"][i]))
        for k in one:
            assert torch.equal(out[k][i], one[k]), (i, k)


# --------------------------------------------------------------------------
# the host caches the pool threads share
# --------------------------------------------------------------------------

def test_bounded_cache_under_threads():
    """More threads than cores on a 4-entry cache, with a short switch
    interval: every hit is the value put for its key, ``put`` returns
    what it stored, and the size never passes the capacity."""
    import os
    import sys
    import threading

    from romanimpreprocess_tpu_torch.utils import hostcache

    cache = hostcache.BoundedCache(4, "test")
    errors = []

    def hammer(t):
        try:
            for i in range(5000):
                k = (t * 7 + i) % 11
                got = cache.get(k)
                assert got is None or got == k * k
                assert cache.put(k, k * k) == k * k
                assert len(cache) <= 4
        except Exception as e:  # noqa: BLE001 -- collected and re-raised below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:1]
    assert len(cache) <= 4


def test_caldir_loaded_once_across_threads(fpa):
    from concurrent.futures import ThreadPoolExecutor

    from romanimpreprocess_tpu_torch.io import calfiles

    calfiles._PACK_CACHE.clear()
    caldir = fpa["configs"][0]["CALDIR"]
    with ThreadPoolExecutor(8) as pool:
        packs = list(pool.map(lambda _: calfiles.load_caldir_cached(caldir), range(16)))
    assert all(p is packs[0] for p in packs)
