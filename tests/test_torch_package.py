"""The port as a package: imports without JAX, backends, devices, I/O.

The JAX package is imported here only as the oracle for the host
substrate the port keeps its own copies of (config codecs, CALDIR
loading, synthetic calibration files).
"""

import dataclasses
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import romanimpreprocess_tpu_torch
from romanimpreprocess_tpu import benchlib as jbenchlib
from romanimpreprocess_tpu import config as jconfig
from romanimpreprocess_tpu.io import calfiles as jcalfiles
from romanimpreprocess_tpu.ops import likely as jlikely
from romanimpreprocess_tpu.ops import ramp as jramp
from romanimpreprocess_tpu.synth import make_cal_files as jmake_cal_files
from romanimpreprocess_tpu_torch import config, synth
from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles, staging
from romanimpreprocess_tpu_torch.ops import cuda_build, rand
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, sim_to_l1
from romanimpreprocess_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "romanimpreprocess_tpu_torch"
READ_PATTERN = synth.READ_PATTERN_DEFAULT


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        romanimpreprocess_tpu_torch.__path__, "romanimpreprocess_tpu_torch."))


def test_every_module_imports_without_jax():
    # a subprocess: this test process already imported jax (conftest);
    # matplotlib and PIL are blocked, as the card's machine lacks them
    code = (
        "import importlib, sys\n"
        "sys.modules.update(matplotlib=None, PIL=None)\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'romanimpreprocess_tpu' or k.startswith('romanimpreprocess_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 32
    for m in ("ops.contract_cuda", "ops.pink", "ops.pink_cuda", "ops.rand",
              "utils.skymodel", "pipeline.sim_to_l1", "ops.ipc_slab",
              "ops.likely", "ops.flat", "utils.bitutils", "galpoisson",
              "galpoisson.pearson", "galpoisson.pearson_torch",
              "galpoisson.find_tilnus", "galpoisson.denoise_construct",
              "pipeline.noise", "pipeline.noise_core", "pipeline.batch", "parallel",
              "benchlib", "validation.coadd_consumer", "validation.many_realizations",
              "calib", "calib.convert", "calib.swconfig", "calib.mast", "calib.make_dark",
              "calib.make_gain", "calib.makemask", "calib.characterize",
              "calib.postprocess", "utils.visualize", "utils.fpaplot", "utils.diff",
              "utils.context_figure", "utils.orientation", "utils.profiling",
              "parallel.spatial", "utils.rows", "utils.time_core", "io.staging"):
        assert "romanimpreprocess_tpu_torch." + m in _modules()


@pytest.mark.parametrize("module,forbidden", [
    # the sim sits below the L1 -> L2 calibration
    ("pipeline.sim_to_l1", "pipeline.l1_to_l2"),
    # the host <-> device boundary sits below every pipeline stage
    ("io.staging", "pipeline"),
])
def test_import_graph(module, forbidden):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('romanimpreprocess_tpu_torch.{module}')\n"
        f"bad = 'romanimpreprocess_tpu_torch.{forbidden}'\n"
        "print(sorted(m for m in sys.modules if m == bad or m.startswith(bad + '.')))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def test_no_port_file_names_jax_or_the_jax_package():
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 25
    pat = re.compile(r"\bjax\b|\bromanimpreprocess_tpu\.")
    for p in files:
        for i, line in enumerate(p.read_text().splitlines(), 1):
            assert not pat.search(line), f"{p.relative_to(ROOT)}:{i}: {line}"


def test_nothing_is_built_at_import():
    assert cuda_build._LIBS == {}
    for src in cuda_build.SOURCES:
        text = (cuda_build.CSRC / src).read_text()
        assert 'extern "C" int' in text and "cudaGetLastError" in text, src
    assert set(cuda_build.SOURCES) == {p.name for p in cuda_build.CSRC.glob("*.cu")}


# --------------------------------------------------------------------------
# devices and backends
# --------------------------------------------------------------------------

#: the fields of ``config.Kernels`` that a ``*_BACKEND`` key with one
#: kernel decides, by key
ONE_KERNEL = {"ipc_fwd": "IPC_BACKEND", "lin": "LIN_BACKEND", "med": "SKY_BACKEND",
              "pink": "PINK_BACKEND"}


@pytest.mark.parametrize("value,dev,want", [
    ("auto", "cpu", "xla"), ("AUTO", "cpu", "xla"), ("xla", "cpu", "xla"),
    ("auto", "cuda", "cuda"), ("xla", "cuda", "xla"), ("cuda", "cuda", "cuda"),
    ("pallas", "cuda", "slab"), ("pallas-stream", "cuda", "slab-stream"),
    ("pallas-frame", "cuda", "cuda"),
])
def test_resolve_backend(value, dev, want):
    # the L1 -> L2 IPC inverse: each Pallas name has its own entry point
    assert config.resolve_kernels({"IPC_BACKEND": value}, dev).ipc == want
    # a key with one kernel: every kernel name selects it
    one = "cuda" if want.startswith("slab") else want
    for field, key in ONE_KERNEL.items():
        got = config.resolve_kernels({key: value}, dev)
        assert getattr(got, field) == one, field
    # every key at once: each field reads its own key only
    every = config.resolve_kernels({k: value for k in ONE_KERNEL.values()}, dev)
    assert every == config.Kernels(ipc=want, ipc_fwd=one, lin=one, med=one, pink=one,
                                   contract="dot")
    with pytest.raises(AttributeError):
        every.lin = "xla"  # the record is immutable


@pytest.mark.parametrize("value", ["cuda", "pallas", "pallas-stream", "pallas-frame"])
def test_kernel_backend_on_cpu_raises(value):
    for key in ONE_KERNEL.values():
        with pytest.raises(ValueError, match=key):
            config.resolve_kernels({key: value}, "cpu")


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="LIN_BACKEND"):
        config.resolve_kernels({"LIN_BACKEND": "triton"}, "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        config.resolve_kernels({"IPC_BACKEND": "slab"}, "cuda")
    assert config.resolve_kernels({}, "cpu") == config.Kernels(
        ipc="xla", ipc_fwd="xla", lin="xla", med="xla", pink="xla", contract="dot")
    assert config.resolve_kernels({}, "cuda") == config.Kernels(
        ipc="cuda", ipc_fwd="cuda", lin="cuda", med="cuda", pink="cuda", contract="dot")


@pytest.mark.parametrize("value,dev,want", [
    (None, "cpu", "dot"), ("dot", "cpu", "dot"), ("auto", "cpu", "dot"),
    ("AUTO", "cuda", "dot"), ("dot", "cuda", "dot"), ("pallas", "cuda", "cuda"),
    ("cuda", "cuda", "cuda"),
])
def test_resolve_contract_backend(value, dev, want):
    cfg = {} if value is None else {"CONTRACT_BACKEND": value}
    assert config.resolve_kernels(cfg, dev).contract == want


@pytest.mark.parametrize("value,exc", [("pallas", "CUDA kernel"), ("cuda", "CUDA kernel"),
                                       ("xla", "unknown backend")])
def test_contract_backend_refused_on_cpu(value, exc):
    with pytest.raises(ValueError, match=exc):
        config.resolve_kernels({"CONTRACT_BACKEND": value}, "cpu")


@pytest.mark.parametrize("key", ["IPC_BACKEND", "PINK_BACKEND", "CONTRACT_BACKEND"])
def test_sim_kernel_backend_on_cpu_device_raises(small, key):
    d, caldir = small
    scene = synth.make_scene_file(d + f"/truth_{key}_1_4.fits", nside_active=56, nstars=2)
    cfg = {"IN": scene, "OUT": d + "/unused.asdf", "CALDIR": caldir, key: "pallas",
           "READS": config.pattern_to_reads(READ_PATTERN)}
    with pytest.raises(ValueError, match=key):
        sim_to_l1.run_config(cfg, device="cpu")


def test_sim_defaults_to_cuda_and_raises_without_one(small):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_to_l1.run_config({"IN": "unused", "OUT": "unused", "READS": [0, 1]})
    with pytest.raises(SystemExit):
        sim_to_l1.main([])  # the config argument is required


def test_no_device_means_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        assert config.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        l1_to_l2.calibrateimage({"IN": "unused", "OUT": "unused", "CALDIR": {}})
    assert config.resolve_device("cpu").type == "cpu"


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_pkg"))
    caldir = synth.make_cal_files(d + "/cal", READ_PATTERN, nside=64, seed=5)
    cal = synth.synth_cal_arrays(64, READ_PATTERN, seed=5)
    data = synth.synth_l1_cube(cal, READ_PATTERN, rate_dn_s=10.0, nborder=4)
    synth.write_l1_file(d + "/L1.asdf", data, READ_PATTERN,
                        amp33=synth.synth_amp33(64, len(READ_PATTERN), 4))
    return d, caldir


def test_cuda_backend_on_cpu_device_raises_in_prepare(small):
    d, caldir = small
    cfg = {"IN": d + "/L1.asdf", "OUT": d + "/x.asdf", "CALDIR": caldir,
           "IPC_BACKEND": "cuda"}
    with pytest.raises(ValueError, match="IPC_BACKEND"):
        l1_to_l2.calibrateimage(cfg, device="cpu")


def test_likelihood_fit_plan_matches_reference(small):
    d, caldir = small
    l1 = asdf_lite.open(d + "/L1.asdf")["roman"]
    pack = calfiles.load_caldir(caldir)
    prep = l1_to_l2.prepare_inputs(l1, {"CALDIR": caldir, "romancal_ramp_fit": True},
                                   pack, device="cpu")
    want = jlikely.build_likely_plan(jramp.ma_table_meta(READ_PATTERN, 3.04), True)
    np.testing.assert_array_equal(prep["plan"].W, want.W)
    assert prep["cfg"]["likelihood_fit"] is True
    np.testing.assert_array_equal(prep["weights_out"], want.W[want.nu // 2, -1])
    assert "likelihood (adaptive-weight) ramp fit" in prep["log"]


def test_synthetic_l1_recovers_injected_rate(small):
    d, caldir = small
    cfg = {"IN": d + "/L1.asdf", "OUT": d + "/L2.asdf", "CALDIR": caldir,
           "SKYORDER": 2, "SLICEOUT": True}
    l1_to_l2.calibrateimage(cfg, device="cpu")
    im = asdf_lite.open(cfg["OUT"])["roman"]
    pack = calfiles.load_caldir(caldir)
    rate = synth.injected_rate(64, 10.0, nborder=4, seed=7)[4:-4, 4:-4]
    ratio = np.median(im["data_withsky"] * pack.flat[4:-4, 4:-4] / rate)
    assert 0.97 < ratio < 1.03
    assert im["meta"]["calibration_software_name"] == "romanimpreprocess_tpu_torch.l1_to_l2"


def test_prepare_inputs_stages_on_device_and_caches(small):
    d, caldir = small
    l1 = asdf_lite.open(d + "/L1.asdf")["roman"]
    pack = calfiles.load_caldir(caldir)
    cfg = {"CALDIR": caldir}
    a = l1_to_l2.prepare_inputs(l1, cfg, pack, device="cpu")
    b = l1_to_l2.prepare_inputs(l1, cfg, pack, device="cpu")
    assert a["cfg"]["ipc"] == a["cfg"]["lin"] == a["cfg"]["med"] == "xla"
    # the core's cfg keeps what the core reads; the prep the whole choice
    assert not {"contract", "pink"} & set(a["cfg"])
    assert a["kernels"] == config.resolve_kernels(cfg, "cpu")
    assert a["arr"]["gain"] is b["arr"]["gain"]  # cal pack staged once
    assert a["arr"]["dark_slope_ipc"] is b["arr"]["dark_slope_ipc"]
    assert a["arr"]["data"].dtype == torch.float32
    assert a["arr"]["mask_dq"].dtype == torch.int32
    np.testing.assert_array_equal(a["arr"]["mask_dq"].numpy().view(np.uint32), pack.mask_dq)
    np.testing.assert_array_equal(a["arr"]["data"].numpy(), np.asarray(l1["data"], np.float32))


def test_prepare_inputs_stages_a_made_mask_per_exposure(small):
    """A pack without a mask file: the zero mask ``prepare_inputs`` makes
    each call is staged per exposure, so a second call adds no entry to
    the staging cache."""
    d, caldir = small
    l1 = asdf_lite.open(d + "/L1.asdf")["roman"]
    pack = dataclasses.replace(calfiles.load_caldir(caldir), mask_dq=None)
    staging._DEVICE_CACHE.clear()
    cfg = {"CALDIR": caldir}
    a = l1_to_l2.prepare_inputs(l1, cfg, pack, device="cpu")
    n = len(staging._DEVICE_CACHE)
    assert 0 < n < staging._DEVICE_CACHE.loose.capacity
    b = l1_to_l2.prepare_inputs(l1, cfg, pack, device="cpu")
    assert len(staging._DEVICE_CACHE) == n
    for p in (a, b):
        assert p["arr"]["mask_dq"].dtype == torch.int32 and not p["arr"]["mask_dq"].any()
    assert a["arr"]["gain"] is b["arr"]["gain"]


@pytest.mark.parametrize("dtype,dq", [(torch.float32, False), (torch.int32, True)])
def test_fetch_from_the_cpu_shares_storage_and_pins_nothing(dtype, dq):
    """From a CPU tensor ``fetch`` and ``to_host`` share its storage as
    ``.cpu()`` does (DQ planes viewed as uint32), count ``d2h_bytes`` and
    leave ``d2h_pinned_bytes`` at 0."""
    t = torch.arange(-6, 6, dtype=dtype).reshape(3, 4)
    key = "pdq" if dq else "slope"
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [staging.fetch(t, dq=dq), staging.to_host({key: t})[key]]
    counters = profiling.snapshot()["counters"]
    assert counters["d2h_bytes"] == 2 * t.nbytes
    assert counters.get("d2h_pinned_bytes", 0) == 0
    for a in got:
        assert np.shares_memory(a, t.numpy())
        assert a.dtype == (np.uint32 if dq else np.float32) and a.shape == (3, 4)
        np.testing.assert_array_equal(a, t.numpy().view(a.dtype))


def test_pack_staged_by_the_sim_is_a_hit_for_prepare_inputs(small):
    """The sim and the L1 -> L2 calibration stage a cal pack through the one
    cache: what ``make_l1_fullcal`` staged, ``prepare_inputs`` reuses on
    the same device."""
    d, caldir = small
    l1 = asdf_lite.open(d + "/L1.asdf")["roman"]
    pack = calfiles.load_caldir(caldir)  # arrays no call has staged
    names = ("gain", "read_sigma", "lin_coefs", "lin_smin", "lin_smax", "lin_sref",
             "lin_dq")
    assert all(staging._DEVICE_CACHE.get((id(getattr(pack, k)), "cpu")) is None
               for k in names)
    sim_to_l1.make_l1_fullcal(rand.sim_generator(3, "cpu"), np.full((56, 56), 5.0, np.float32),
                              READ_PATTERN, pack, crparam={})
    staged = {k: staging._DEVICE_CACHE.get((id(getattr(pack, k)), "cpu"))[0] for k in names}
    prep = l1_to_l2.prepare_inputs(l1, {"CALDIR": caldir}, pack, device="cpu")
    for k in names:
        assert prep["arr"][k] is staged[k], k


def test_prepare_inputs_works_out_the_median_gain_once_a_pack(small, monkeypatch):
    d, caldir = small
    l1 = asdf_lite.open(d + "/L1.asdf")["roman"]
    loaded = calfiles.load_caldir(caldir)
    pack = dataclasses.replace(loaded, gain=loaded.gain.copy())  # a gain no call has seen
    want = float(np.median(pack.gain))
    median, seen = np.median, []

    def counted(a, *args, **kwargs):
        seen.append(a)
        return median(a, *args, **kwargs)

    monkeypatch.setattr(np, "median", counted)
    cfg = {"CALDIR": caldir}
    got = [l1_to_l2.prepare_inputs(l1, cfg, pack, device="cpu")["medgain"] for _ in range(2)]
    assert [np.float64(g).tobytes() for g in got] == [np.float64(want).tobytes()] * 2
    assert sum(a is pack.gain for a in seen) == 1
    changed = dataclasses.replace(pack, gain=pack.gain * np.float32(1.5))
    again = l1_to_l2.prepare_inputs(l1, cfg, changed, device="cpu")["medgain"]
    assert sum(a is changed.gain for a in seen) == 1
    assert np.float64(again).tobytes() == np.float64(median(changed.gain)).tobytes()
    assert again != want


# --------------------------------------------------------------------------
# host substrate against the JAX package's copies
# --------------------------------------------------------------------------

def test_read_pattern_codecs_match():
    reads = [0, 1, 1, 3, 3, 6, 7, 9]
    assert config.reads_to_pattern(reads) == jconfig.reads_to_pattern(reads)
    pat = config.reads_to_pattern(reads)
    assert config.pattern_to_reads(pat) == jconfig.pattern_to_reads(pat)
    for cmd, ch in (("RS2Pg4", "S"), ("RS2Pg4", "P"), ("Rz4PbrS2C1", "C")):
        assert config.layer_subscript(cmd, ch) == jconfig.layer_subscript(cmd, ch)


def test_synth_files_and_caldir_load_identical(tmp_path):
    ct = synth.make_cal_files(str(tmp_path / "t"), READ_PATTERN, nside=48, seed=3)
    cj = jmake_cal_files(str(tmp_path / "j"), READ_PATTERN, nside=48, seed=3)
    assert sorted(ct) == sorted(cj)
    pt, pj = calfiles.load_caldir(ct), jcalfiles.load_caldir(cj)
    for name, vj in vars(pj).items():
        vt = getattr(pt, name)
        if isinstance(vj, np.ndarray):
            np.testing.assert_array_equal(vt, vj, err_msg=name)
            assert vt.dtype == vj.dtype, name
        elif not isinstance(vj, dict):
            assert vt == vj, name
    assert calfiles.amp33_optimal_slope(pt) == jcalfiles.amp33_optimal_slope(pj)


def test_synth_arrays_match_benchlib():
    at = synth.synth_cal_arrays(32, READ_PATTERN, seed=4)
    aj = jbenchlib.synth_cal_arrays(32, READ_PATTERN, seed=4)
    for k, v in aj.items():
        np.testing.assert_array_equal(np.asarray(at[k]), np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(synth.synth_l1_cube(at, READ_PATTERN),
                                  jbenchlib.synth_l1_cube(aj, READ_PATTERN))


def test_write_l1_file_layout(tmp_path):
    data = np.zeros((len(READ_PATTERN), 16, 16), np.uint16)
    p = synth.write_l1_file(str(tmp_path / "L1.asdf"), data, READ_PATTERN,
                            amp33=synth.synth_amp33(16, len(READ_PATTERN), 4))
    r = asdf_lite.open(p)["roman"]
    assert r["data"].dtype == np.uint16 and r["amp33"].shape == (6, 16, 4)
    assert r["meta"]["exposure"]["read_pattern"] == READ_PATTERN
    assert r["meta"]["instrument"]["detector"] == "WFI04"
    with pytest.raises(ValueError):
        synth.write_l1_file(str(tmp_path / "bad.asdf"), data.astype(np.float32),
                            READ_PATTERN)
    assert os.path.getsize(p) > data.nbytes
