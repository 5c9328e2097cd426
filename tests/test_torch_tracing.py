"""The port's recorder (``utils.profiling``): spans and counters gated on
a recording ``torch.profiler``, self time, the trace's ``spans.json``,
the named caches' hit and miss counts, the L1 -> L2 host driver's spans
and byte counters over two ``calibrate_tree`` calls at 64^2, and the
per-layer readers that divide them by the call count."""

import functools
import json
import os
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from romanimpreprocess_tpu_torch import synth
from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles, staging
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2
from romanimpreprocess_tpu_torch.utils import hostcache, profiling, typefix

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import program_spans  # noqa: E402

torch.set_num_threads(1)

N = 64
RP = synth.READ_PATTERN_DEFAULT
#: the staging cache (a cal pack's arrays, IPC precal and kernel planes,
#: held together), whose misses come on the first call only
STAGING_CACHES = ("device_arrays",)
#: the spans each call opens once
ONCE = ("host.calibrate", "host.prepare", "host.prepare.plan", "host.prepare.medgain",
        "host.to_host", "host.package", "host.package.maps", "host.package.refdata",
        "host.package.meta", "host.typefix")


def _recording():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_recorder_is_off_without_a_profiler():
    profiling.reset()
    with profiling.span("test.off"):
        profiling.count("test.off", 3)
    assert profiling.snapshot() == {"spans": {}, "counters": {}, "gauges": {}}


def test_nested_spans_self_time_and_counters():
    @profiling.span("test.leaf")
    def leaf():
        time.sleep(0.002)

    profiling.reset()
    with _recording() as prof:
        with profiling.span("test.outer"):
            time.sleep(0.002)
            with profiling.span("test.inner"):
                leaf()
                leaf()
            profiling.count("test.n", 2)
            profiling.count("test.n", 5)
    snap = profiling.snapshot()
    s = snap["spans"]
    assert {k: v["count"] for k, v in s.items()} == {
        "test.outer": 1, "test.inner": 1, "test.leaf": 2}
    assert snap["counters"] == {"test.n": 7}
    assert s["test.outer"]["self_ms"] == pytest.approx(
        s["test.outer"]["total_ms"] - s["test.inner"]["total_ms"], abs=1e-9)
    assert s["test.inner"]["self_ms"] == pytest.approx(
        s["test.inner"]["total_ms"] - s["test.leaf"]["total_ms"], abs=1e-9)
    assert s["test.leaf"]["self_ms"] == s["test.leaf"]["total_ms"] >= 4.0
    assert s["test.outer"]["self_ms"] >= 2.0
    assert all(v["minflt"] >= 0 and v["sys_ms"] >= 0 for v in s.values())
    names = {e.key for e in prof.key_averages()}
    assert {"test.outer", "test.inner", "test.leaf"} <= names
    # off again once the profiler stops
    with profiling.span("test.outer"):
        profiling.count("test.n")
    assert profiling.snapshot() == snap


def test_threads_lose_no_update():
    """More threads than cores, each opening nested spans and counting,
    with a short switch interval: every count and span arrives."""
    nthreads, rounds = 2 * (os.cpu_count() or 1) + 2, 300

    def work():
        for _ in range(rounds):
            with profiling.span("test.thread"):
                with profiling.span("test.thread.inner"):
                    profiling.count("test.thread")

    profiling.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _recording():
            threads = [threading.Thread(target=work) for _ in range(nthreads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = profiling.snapshot()
    assert snap["counters"] == {"test.thread": nthreads * rounds}
    s = snap["spans"]
    assert s["test.thread"]["count"] == s["test.thread.inner"]["count"] == nthreads * rounds
    # each thread's inner spans are its own outer spans' children
    assert s["test.thread"]["self_ms"] == pytest.approx(
        s["test.thread"]["total_ms"] - s["test.thread.inner"]["total_ms"], rel=1e-6)


def test_trace_writes_spans_json(tmp_path):
    with _recording():
        with profiling.span("test.before"):
            pass
    with profiling.trace(str(tmp_path / "ok")):
        with profiling.span("test.body"):
            profiling.count("test.bytes", 8)
    got = json.loads((tmp_path / "ok" / profiling.SPANS_FILE).read_text())
    assert set(got["spans"]) == {"test.body"}  # reset at the start
    assert got["spans"]["test.body"]["count"] == 1
    assert got["counters"] == {"test.bytes": 8}
    assert (tmp_path / "ok" / profiling.TRACE_FILE).is_file()
    # written when the body raises, too
    with pytest.raises(ValueError), profiling.trace(str(tmp_path / "err")):
        with profiling.span("test.raised"):
            raise ValueError("inside")
    got = json.loads((tmp_path / "err" / profiling.SPANS_FILE).read_text())
    assert got["spans"]["test.raised"]["count"] == 1


def test_bounded_cache_counts_hits_and_misses():
    c = hostcache.BoundedCache(2, "test")
    profiling.reset()
    c.get("a")
    assert profiling.snapshot()["counters"] == {}
    with _recording():
        assert c.get("a") is None and c.get("a", 5) == 5
        c.put("a", 1)
        assert c.get("a") == 1
        c.put("b", None)
        assert c.get("b", 7) is None  # a stored None is a hit
    assert profiling.snapshot()["counters"] == {"cache.test.miss": 2, "cache.test.hit": 2}


# ---- the host <-> device boundary (io.staging) ----


@pytest.mark.parametrize("dtype,back,nbytes", [
    (np.uint16, staging.u16_to_host, 2),
    (np.uint32, functools.partial(staging.to_numpy, dq=True), 4),
    (np.float32, staging.fetch, 4), (np.float64, staging.fetch, 4),
])
def test_wire_formats_both_ways(monkeypatch, dtype, back, nbytes):
    """Each host dtype crosses in its wire format, ``nbytes`` a value each
    way: uint16 counts as int16 (int32 on the device), uint32 DQ as
    int32 bit patterns, other floats as float32; the values come back as
    they went, the copy to the device counted as ``h2d_bytes`` under
    ``host.stage`` and the counted copy back (``fetch``) as ``d2h_bytes``."""
    vals = {np.uint16: [0, 1, 32767, 32768, 65535],
            np.uint32: [0, 1, 2**31 - 1, 2**31, 2**32 - 1]}
    a = np.array(vals.get(dtype, [0.0, -1.5, 3.25e6, 7.0e-8, 1.0]), dtype).reshape(1, 5)
    crossed, cpu = [], torch.Tensor.cpu

    def spy(t, *args, **kwargs):
        crossed.append(t.nbytes)
        return cpu(t, *args, **kwargs)

    profiling.reset()
    with _recording():
        t = staging.stage(a, "cpu", cache=False)
        monkeypatch.setattr(torch.Tensor, "cpu", spy)
        got = back(t)
        monkeypatch.undo()
    snap = profiling.snapshot()
    assert t.dtype == (torch.int32 if dtype in (np.uint16, np.uint32) else torch.float32)
    assert snap["counters"]["h2d_bytes"] == crossed[0] == a.size * nbytes
    assert snap["spans"]["host.stage"]["count"] == 1
    assert snap["counters"].get("d2h_bytes", 0) == (
        a.size * nbytes if back is staging.fetch else 0)
    assert got.dtype == (np.float32 if dtype == np.float64 else dtype)
    np.testing.assert_array_equal(got, a.astype(got.dtype))


# ---- the L1 -> L2 host driver ----


def _sent(a):
    """Bytes :func:`staging.stage` sends for ``a``: uint16 as 2 bytes a
    value, uint32 and float32 as they are, anything else as float32."""
    a = np.asarray(a)
    return a.size * (2 if a.dtype == np.uint16 else 4)


@pytest.fixture(scope="module")
def two_calls(tmp_path_factory):
    """Two ``calibrate_tree`` + ``typefix.fix`` calls of one exposure on
    one fresh cal pack inside ``profiling.trace``, with the recorder's
    snapshot after each."""
    d = tmp_path_factory.mktemp("tracing")
    caldir = synth.make_cal_files(str(d / "cal"), RP, nside=N, seed=5)
    cal = synth.synth_cal_arrays(N, RP, seed=5)
    synth.write_l1_file(str(d / "L1.asdf"),
                        synth.synth_l1_cube(cal, RP, rate_dn_s=10, nborder=4), RP,
                        amp33=synth.synth_amp33(N, len(RP), 4))
    config = {"IN": str(d / "L1.asdf"), "CALDIR": caldir, "SKYORDER": 2, "SLICEOUT": True}
    pack = calfiles.load_caldir(caldir)
    l1 = asdf_lite.open(config["IN"])["roman"]
    area = np.ones((N, N), np.float32)
    snaps, outs, trees = [], [], []
    with profiling.trace(str(d / "prof")):
        for _ in range(2):
            tree, out = l1_to_l2.calibrate_tree(l1, config, pack, area, device="cpu")
            typefix.fix(tree)
            outs.append(out)
            trees.append(tree)
            snaps.append(profiling.snapshot())
    events = json.loads((d / "prof" / profiling.TRACE_FILE).read_text())["traceEvents"]
    spans_json = json.loads((d / "prof" / profiling.SPANS_FILE).read_text())
    return SimpleNamespace(pack=pack, l1=l1, area=area, snaps=snaps, outs=outs, trees=trees,
                           config=config, events=events, spans_json=spans_json)


def _per_call(two_calls, group):
    """Each call's span counts (``spans``) or counter values (``counters``)."""
    def flat(snap):
        return {k: v if group == "counters" else v["count"] for k, v in snap[group].items()}

    first, both = (flat(snap) for snap in two_calls.snaps)
    return first, {k: v - first.get(k, 0) for k, v in both.items()}


def test_two_calls_count_spans_and_calls(two_calls):
    assert two_calls.spans_json == two_calls.snaps[-1]
    first, second = _per_call(two_calls, "spans")
    assert first["host.calibrate"] == second["host.calibrate"] == 1
    for name in ONCE:
        assert first[name] == second[name] == 1, name
    # staging copies on a miss only: the cal pack's on the first call
    assert first["host.ipc_precal"] == first["host.kernel_planes"] == 1
    assert second.get("host.ipc_precal", 0) == second.get("host.kernel_planes", 0) == 0
    assert first["host.stage"] > second["host.stage"] > 0
    # the host driver's spans and the core's stages, nothing else
    assert all(k.startswith(("host.", "l1_to_l2.")) for k in first), sorted(first)
    assert {"l1_to_l2.saturation", "l1_to_l2.linearity", "l1_to_l2.endslice"} <= set(first)
    # the product maps, made beside the core's outputs before the copy back
    assert first["l1_to_l2.maps"] == second["l1_to_l2.maps"] == 1


def test_two_calls_count_cache_misses_on_the_first_call_only(two_calls):
    first, second = _per_call(two_calls, "counters")
    for name in STAGING_CACHES:
        assert first.get(f"cache.{name}.miss", 0) > 0, name
        assert second.get(f"cache.{name}.miss", 0) == 0, name
        assert second.get(f"cache.{name}.hit", 0) > 0, name
    # the IPC kernel is sent inside the precal, uncached (only the precal
    # reads it): every array looked up on the first call hits on the second
    assert first["cache.device_arrays.miss"] == second["cache.device_arrays.hit"]
    # the median gain: worked out on the first call only, its span open on every call
    snap = two_calls.snaps[-1]
    calls = snap["spans"]["host.calibrate"]["count"]
    assert first["cache.medgain.miss"] == snap["counters"]["cache.medgain.miss"] == 1
    assert snap["counters"]["cache.medgain.hit"] == calls - 1
    assert snap["spans"]["host.prepare.medgain"]["count"] == calls


def test_two_calls_count_the_bytes_staged_and_read_back(two_calls):
    pack, l1, area = two_calls.pack, two_calls.l1, two_calls.area
    first, second = _per_call(two_calls, "counters")
    ngrp = len(RP)
    # each call: the L1 cube and amp33, the area map, the decay signal,
    # the WFI18 row basis, the amp33 slope scalar
    per_exposure = (_sent(l1["data"]) + _sent(l1["amp33"]) + _sent(area)
                    + 4 * ngrp + 4 * N * 2 + 4)
    assert second["h2d_bytes"] == per_exposure
    # the first call also stages the cal pack, the IPC precal and planes
    cal = [getattr(pack, k) for k in (
        "amp33_med", "dark_cube", "dark_slope", "dark_dq", "gain", "read_sigma", "mask_dq",
        "saturation", "saturation_dq", "biascorr", "lin_coefs", "lin_smin", "lin_smax",
        "lin_sref", "lin_dq", "flat", "ipc_kernel")]
    na = N - 8
    precal = 4 * na * na * (2 + 1 + 1)  # the stacked pair, gain twice
    planes = 4 * 9 * N * N
    assert first["h2d_bytes"] == per_exposure + sum(
        _sent(a) for a in cal if a is not None) + precal + planes
    # the core's outputs and the product maps, in one copy back
    for out, tree, got in zip(two_calls.outs, two_calls.trees, (first, second)):
        maps = sum(tree["roman"][k].nbytes for k in ("err", "var_poisson", "var_rnoise"))
        assert maps == 3 * 4 * (N - 8) ** 2
        assert got["d2h_bytes"] == sum(a.nbytes for a in out.values()) + maps
    assert "gather_bytes" not in first  # one part: nothing gathered


def test_maps_counters_count_where_the_maps_were_made(two_calls):
    """``maps_host`` once a call where the core ran on the CPU, and once
    where ``package_tree`` makes the maps from host outputs alone;
    ``maps_device`` (the card's) never here."""
    first, second = _per_call(two_calls, "counters")
    assert first["maps_host"] == second["maps_host"] == 1
    assert "maps_device" not in two_calls.snaps[-1]["counters"]
    prep = l1_to_l2.prepare_inputs(two_calls.l1, two_calls.config, two_calls.pack,
                                   two_calls.area, device="cpu")
    profiling.reset()
    with _recording():
        tree = l1_to_l2.package_tree(two_calls.outs[-1], prep, two_calls.l1, two_calls.config)
    snap = profiling.snapshot()
    assert snap["counters"] == {"maps_host": 1}
    assert snap["spans"]["host.package.maps"]["count"] == 1
    assert "l1_to_l2.maps" in snap["spans"]
    for k in ("err", "var_poisson", "var_rnoise"):
        np.testing.assert_array_equal(tree["roman"][k], two_calls.trees[-1]["roman"][k])


def test_chrome_trace_holds_each_host_span_once_a_call(two_calls):
    ranges = [e for e in two_calls.events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in ranges
                   if e["name"] == "host.calibrate")
    assert len(calls) == 2
    for a, b in calls:
        inside = [e["name"] for e in ranges
                  if e["name"].startswith("host.") and a <= e["ts"] <= b]
        for name in ONCE[:-1]:  # typefix runs after the call
            assert inside.count(name) == 1, name
    hosts = [e["name"] for e in ranges if e["name"].startswith("host.")]
    assert hosts.count("host.typefix") == 2
    assert not any(n.startswith("l1_to_l2.") for n in hosts)
    stages = sorted((e["ts"], e["ts"] + e["dur"]) for e in ranges
                    if e["name"].startswith("l1_to_l2."))
    assert len(stages) >= 2 * 8
    for (a0, b0), (a1, _) in zip(stages, stages[1:]):
        assert b0 <= a1, "l1_to_l2.* ranges overlap"


# ---- the per-layer readers ----


def _canned(ncalls):
    def sp(total, self_=None, count=ncalls, minflt=0):
        return {"count": count, "total_ms": total,
                "self_ms": total if self_ is None else self_, "minflt": minflt,
                "sys_ms": minflt / 100}

    return {"spans": {
        "host.calibrate": sp(2000.0, 10.0),
        "host.prepare": sp(600.0, 200.0, minflt=1000),
        "host.prepare.plan": sp(20.0),
        "host.prepare.medgain": sp(180.0),
        "host.stage": sp(150.0, count=9),
        "host.ipc_precal": sp(60.0, 40.0, count=1),
        "host.kernel_planes": sp(10.0, count=1),
        "host.to_host": sp(300.0, minflt=3000),
        "host.package": sp(500.0, 20.0, minflt=4000),
        "host.typefix": sp(4.0, minflt=2),
        "l1_to_l2.saturation": sp(30.0),
        "l1_to_l2.ipc": sp(50.0),
        "sim_to_l1.fill": sp(999.0),
    }, "counters": {
        "h2d_bytes": ncalls * 344_000_000, "d2h_bytes": ncalls * 352_000_000,
        "cache.device_arrays.hit": 97, "cache.device_arrays.miss": 1,
        "cache.ipc_precal.hit": 2, "cache.kernel_planes.hit": 2,
        "cache.wcs.miss": 2,
    }}


def _ctx(ncalls):
    return SimpleNamespace(spans=SimpleNamespace(calls=[{}] * ncalls), dev=None,
                           kind="cpu", shapes={})


READERS = {
    # staging: the three spans' self times, nested stage once
    "staging_span_ms": (150.0 + 40.0 + 10.0) / 2,
    "host_prepare_span_ms": (600.0 - 200.0) / 2,
    "host_package_span_ms": (300.0 + 500.0 + 4.0) / 2,
    "staging_staged_mb": 344.0,
    "staging_hit_pct": 100.0 * 101 / 102,
    "host_d2h_mb": 352.0,
    "host_faults_k": (1000 + 3000 + 4000 + 2) / 2 / 1e3,
    "host_sys_ms": (10 + 30 + 40 + 0.02) / 2,
    "core_host_ms": (30.0 + 50.0) / 2,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_divide_by_the_call_count(monkeypatch, name):
    read = getattr(program_spans, name)
    monkeypatch.setattr(profiling, "snapshot", lambda: _canned(2))
    assert read(_ctx(2)) == pytest.approx(READERS[name])
    assert read(_ctx(3)) is None  # the recorder saw other calls
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counters": {}})
    assert read(_ctx(2)) is None
    assert read(_ctx(0)) is None
    monkeypatch.delattr(profiling, "snapshot")  # a program with no recorder
    assert read(_ctx(2)) is None


def test_metric_files_bind_the_readers():
    from gpubench import spec

    bench = spec.benchmark(ROOT)
    names = {m["name"]: m for m in bench["per_layer"] if m["source"] == "program_span"}
    for metric in ("host.prepare_span_ms", "host.package_span_ms", "staging.span_ms",
                   "staging.staged_mb", "staging.hit_pct", "host.d2h_mb", "host.faults_k",
                   "host.sys_ms", "core.host_ms"):
        assert names[metric]["moves"] == "sca_per_s"
        assert spec.reader(metric) is getattr(program_spans, metric.replace(".", "_"))


def test_readers_on_the_two_calls(two_calls, monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: two_calls.snaps[-1])
    ctx = _ctx(2)
    first, second = _per_call(two_calls, "counters")
    assert program_spans.staging_staged_mb(ctx) == pytest.approx(
        (first["h2d_bytes"] + second["h2d_bytes"]) / 2 / 1e6)
    assert 0 < program_spans.staging_hit_pct(ctx) < 100
    prep = program_spans.host_prepare_span_ms(ctx)
    assert 0 < prep < two_calls.snaps[-1]["spans"]["host.prepare"]["total_ms"] / 2
    assert program_spans.core_host_ms(ctx) > 0


# ---- the exposure lane (noise_core.make_staged_exposure_runner) ----

#: the prefixes of the lane's device ranges, as the benchmark's entry reads them
LANE_RANGES = ("sim_to_l1.", "noise.", "l1_to_l2.")


def _lane_draws(nside, nb, cw, read_pattern, layers, frame_time=3.04):
    """Variates one lane call draws, from the shapes alone, for layers
    without 'O' (whose rejection draws as many as it needs)."""
    from romanimpreprocess_tpu_torch.ops import pink

    ngrp, nreads, na = len(read_pattern), read_pattern[-1][-1] + 1, nside - 2 * nb
    lam_cr = 8.0e-6 * frame_time * (nreads - 1) * na * na
    kcap = max(256, int(-(-(lam_cr + 8.0 * lam_cr**0.5 + 8.0) // 256)) * 256)
    sim = na * na + nreads * na * na + 1 + 7 * kcap + ngrp * na * na
    nframes = ngrp * (2 + nside // cw)
    length = 2 * nside * cw
    if length >= pink.MXU_MIN_LENGTH:
        white = (nframes + 1) // 2 * 2 * length
    else:
        white = nframes * 2 * (length // 2 + 1)
    strips = 2 * (ngrp + 1) * nb * nside + 2 * (ngrp + 1) * (nside - 2 * nb) * nb
    fill = strips + white + ngrp * nside * cw
    n_r = sum("R" in c for c in layers)
    n_pr = sum("P" in c for c in layers)
    return sim + (1 + n_r) * fill + n_r * ngrp * na * na + n_pr * nreads * na * na


def _lane_calls(tmp_path, layers, ncalls=2):
    from romanimpreprocess_tpu_torch import benchlib
    from romanimpreprocess_tpu_torch.pipeline import noise_core

    arr, prep, pack = benchlib.exposure_bundle(nside=N, device="cpu")
    run = noise_core.make_staged_exposure_runner(prep, pack, layers)
    profiling.reset()
    cubes = []
    with _recording() as prof:
        for seed in range(ncalls):
            cube, _, _ = run(100 + seed, arr)
            cubes.append(noise_core.cube_to_host(cube))
    path = tmp_path / "lane_trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    return SimpleNamespace(snap=profiling.snapshot(), events=events, cubes=cubes,
                           prep=prep, pack=pack)


def test_exposure_lane_leaf_ranges_do_not_nest(tmp_path):
    """The lane's device ranges are leaves (the trace gives a launch to
    the range open at it); host.lane opens once a call; the copy back
    counts the cube's bytes."""
    got = _lane_calls(tmp_path, ["Rz4PbrS2C1", "Rz4OS2C5"])
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in got.events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith(LANE_RANGES))
    names = {r[2] for r in ranges}
    for name in ("sim_to_l1.poisson", "sim_to_l1.contract", "sim_to_l1.ipc_fwd",
                 "sim_to_l1.inv_linearity", "sim_to_l1.read_noise", "sim_to_l1.fill.pink",
                 "noise.perturb", "noise.diff", "noise.pearson", "noise.resample",
                 "noise.contract", "noise.medfit", "noise.stack", "l1_to_l2.ramp_fit"):
        assert name in names, name
    for (a0, b0, n0), (a1, _, n1) in zip(ranges, ranges[1:]):
        assert b0 <= a1, f"{n0} and {n1} overlap"
    spans = got.snap["spans"]
    assert spans["host.lane"]["count"] == 2
    assert spans["host.noise.base"]["count"] == 2
    assert spans["host.noise.layer1"]["count"] == 2
    assert got.snap["counters"]["d2h_bytes"] == sum(c.nbytes for c in got.cubes)
    assert got.cubes[0].shape == (2, N - 8, N - 8)


def test_exposure_lane_counts_its_draws(tmp_path):
    """``rng_draws`` counts every variate of the sim, the fills, the
    white read noise and the 'P...r' resample, as the shapes give them."""
    layers = ["Rz4PbrS2C1", "Rz4S2C2"]
    got = _lane_calls(tmp_path, layers)
    nside, nb, cw = got.prep["geom"]
    want = _lane_draws(nside, nb, cw, got.prep["read_pattern"], layers)
    assert got.snap["counters"]["rng_draws"] == 2 * want
