"""The benchmark's focal-plane cell (``l2_classic.fpa18``) on the CPU at
128^2: the ``l1_to_l2`` entry over 3 SCAs' cal packs x 2 exposures in the
mix's order, held to the plain reference bit for bit, with every pack
resident and with a budget that holds two; and the cell's three staging
readers on a canned snapshot."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import spec  # noqa: E402
from romanimpreprocess_tpu_torch.io import staging  # noqa: E402
from romanimpreprocess_tpu_torch.utils import profiling  # noqa: E402

CELL = "l2_classic.fpa18"
#: the benchmark's test size: 128^2 with the production channel count (32 of 4)
SMALL = {"nside": 128, "channelwidth": 4}
SEED = 2**31 + 4099
READERS = ("staging.pack_mb", "staging.pack_hit_pct", "staging.resident_gb")

torch.set_num_threads(2)


def _entry(tmp_path):
    """The cell's entry on the CPU at 128^2, its mix cut to 3 SCAs."""
    bench = spec.benchmark(ROOT)
    wl = spec.cell(bench, CELL)
    cfg = dict(spec.config(wl["config"]), **SMALL)
    mix = dict(spec.traffic(wl["traffic"]), scas=3)
    assert mix["exposures"] == 2
    ent = spec.entry(cfg["entry"])
    ent.check(cfg)
    return ent.Entry(cfg, mix, SEED, torch.device("cpu"), tmp_path)


def test_the_cell_is_the_classic_configuration_over_the_focal_plane():
    bench = spec.benchmark(ROOT)
    wl = spec.cell(bench, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("l2_classic_fpa18", "fpa18", 1)
    mix = spec.traffic("fpa18")
    assert (mix["scas"], mix["exposures"], mix["warm_calls"]) == (18, 2, 18)
    names = [m["name"] for m in spec.metrics_of(bench, CELL, per_layer=True)]
    assert set(READERS) <= set(names)
    for other in ("l2_classic.sca1", "l2_likely.sca1"):
        assert set(READERS) <= {m["name"] for m in spec.metrics_of(bench, other, True)}
    assert not set(READERS) & {m["name"] for m in spec.metrics_of(bench, "exposure_lane.sca1",
                                                                    True)}


def test_the_focal_plane_configuration_is_the_classic_call_over_its_scas():
    """The deployment runs ``l2_classic``'s call unchanged, under its
    limits; what it adds is the layout, which the mix carries out, and
    the one cut of scale, which ``reduced`` names."""
    bench = spec.benchmark(ROOT)
    wl = spec.cell(bench, CELL)
    cfg, base = spec.config(wl["config"]), spec.config("l2_classic")
    layout = {"scas_per_card", "exposures_per_sca"}
    prose = {"source", "what", "cut"}
    assert set(cfg) - set(base) == layout | {"cut"}
    assert {k: v for k, v in cfg.items() if k not in layout | prose} == {
        k: v for k, v in base.items() if k not in prose}
    assert spec.limits(wl["config"]) == spec.limits("l2_classic")
    mix = spec.traffic(wl["traffic"])
    assert (cfg["scas_per_card"], cfg["exposures_per_sca"]) == (mix["scas"], mix["exposures"])
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    assert entry["reduced"] == ["exposures_per_sca"]
    assert entry["file"] == f"gpubench/configs/{wl['config']}.json"


@pytest.mark.parametrize("fit", ["all", "two"])
def test_entry_over_three_packs_matches_the_reference(tmp_path, monkeypatch, fit):
    """Exposure after exposure over 3 packs: with every pack resident the
    second exposure finds each whole; with room for two, one lookup in
    three misses.  Every call's tree is the reference's bit for bit."""
    e = _entry(tmp_path)
    assert e.items == [(s, x) for x in range(2) for s in range(3)]
    cache = staging._DEVICE_CACHE
    cache.clear()
    if fit == "two":
        e.call(e.items[0])
        one = cache.resident_bytes
        cache.clear()
        monkeypatch.setattr(cache, "_budget", 2 * one + one // 2)
    profiling.reset()
    trees = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for item in e.items:
            trees.append(e.call(item))
    c = profiling.snapshot()["counters"]
    assert c["pack_misses"] == (3 if fit == "all" else 4)
    assert c.get("pack_hits", 0) == (3 if fit == "all" else 2)
    resident = cache.resident_bytes
    assert resident > 0
    e.free()
    assert cache.resident_bytes == 0
    for item, tree in zip(e.items, trees):
        assert e.numbers(tree, e.reference(item)) == {"exact_frac": 0.0, "maps_gap": 0.0}, item
    if fit == "two":
        assert resident == 2 * one


def _canned(calls=2, gauges=True, counters=None):
    snap = {"spans": {"host.calibrate": {"count": calls, "total_ms": 700.0, "self_ms": 0.0,
                                         "minflt": 0, "sys_ms": 0.0}},
            "counters": {"pack_staged_bytes": 6_000_000, "pack_hits": 3, "pack_misses": 1}
            if counters is None else counters,
            "gauges": {"pack_resident_bytes": 55_600_000_000} if gauges else {}}
    return snap


def _ctx(ncalls):
    return SimpleNamespace(spans=SimpleNamespace(calls=[{}] * ncalls), dev=None, kind="cpu",
                           shapes={})


@pytest.mark.parametrize("name,want", [("staging.pack_mb", 3.0),
                                       ("staging.pack_hit_pct", 75.0),
                                       ("staging.resident_gb", 55.6)])
def test_staging_readers_on_a_canned_snapshot(monkeypatch, name, want):
    from gpubench import program_spans

    read = spec.reader(name)
    monkeypatch.setattr(program_spans, "snapshot", lambda: _canned())
    assert read(_ctx(2)) == pytest.approx(want)
    # the recorder saw other calls than the traced ones
    assert read(_ctx(3)) is None
    assert read(SimpleNamespace(spans=None)) is None
    # a program without a recorder
    monkeypatch.setattr(program_spans, "snapshot", lambda: None)
    assert read(_ctx(2)) is None


def test_staging_readers_with_nothing_staged_or_no_pack_counters(monkeypatch):
    """Every pack resident: 0 MB staged and 100% found whole; a program
    that keeps no pack counters (no gauge, no lookups): None."""
    from gpubench import program_spans

    mb, hit, gb = (spec.reader(n) for n in READERS)
    monkeypatch.setattr(program_spans, "snapshot",
                        lambda: _canned(counters={"pack_hits": 36}))
    assert mb(_ctx(2)) == 0.0 and hit(_ctx(2)) == 100.0 and gb(_ctx(2)) == pytest.approx(55.6)
    monkeypatch.setattr(program_spans, "snapshot",
                        lambda: _canned(gauges=False, counters={"h2d_bytes": 10}))
    assert [r(_ctx(2)) for r in (mb, hit, gb)] == [None, None, None]
