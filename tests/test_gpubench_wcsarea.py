"""The benchmark's per-exposure WCS cell (``l2_classic.wcsarea``) on the
CPU at 128^2: the ``l1_to_l2_wcs`` entry over 3 pointings, each call's
map made from its sidecar inside the call, held to the plain reference
with the frozen map; the control and a neighbouring pointing's map fail
``area_gap``; a run of the harness; and the cell's three readers on a
canned snapshot."""

import io
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import harness, spec  # noqa: E402
from romanimpreprocess_tpu_torch.utils import profiling  # noqa: E402

CELL = "l2_classic.wcsarea"
#: the benchmark's test size: 128^2 with the production channel count (32 of 4)
SMALL = {"nside": 128, "channelwidth": 4}
SEED = 2**31 + 8191
READERS = ("wcs.area_device_ms", "wcs.area_span_ms", "wcs.area_device_pct")

torch.set_num_threads(2)


def _limits():
    return spec.limits(spec.cell(spec.benchmark(ROOT), CELL)["config"])


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    """The cell's entry on the CPU at 128^2, its mix cut to 3 pointings."""
    wl = spec.cell(spec.benchmark(ROOT), CELL)
    cfg = dict(spec.config(wl["config"]), **SMALL)
    mix = dict(spec.traffic(wl["traffic"]), pointings=3)
    ent = spec.entry(cfg["entry"])
    ent.check(cfg)
    return ent.Entry(cfg, mix, SEED, torch.device("cpu"), tmp_path_factory.mktemp("wcsarea"))


def test_the_cell_is_the_classic_call_with_the_map():
    """``l2_classic``'s call, keys and limits, with the map's limit, the
    WCS draws and nothing cut."""
    bench = spec.benchmark(ROOT)
    wl = spec.cell(bench, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("l2_classic_wcsarea", "wcsarea", 1)
    cfg, base = spec.config(wl["config"]), spec.config("l2_classic")
    drawn = {"wcs_scale_jitter", "wcs_sip_sigma", "dither_deg"}
    prose = {"source", "what", "precision", "assumed"}
    assert set(cfg) - set(base) == drawn
    assert {k: v for k, v in cfg.items() if k not in drawn | prose | {"entry"}} == {
        k: v for k, v in base.items() if k not in prose | {"entry"}}
    assert cfg["entry"] == "l1_to_l2_wcs" and "float64" in cfg["precision"]
    assert all(any(k in a for a in cfg["assumed"]) for k in drawn)
    lim = spec.limits(wl["config"])
    assert {k: v for k, v in lim.items() if k != "area_gap"} == spec.limits("l2_classic")
    assert 0 < lim["area_gap"] < 1e-3
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    assert conf["reduced"] == [] and conf["file"] == f"gpubench/configs/{wl['config']}.json"
    mix = spec.traffic(wl["traffic"])
    assert (mix["scas"], mix["exposures"], mix["pointings"]) == (1, 8, 4096)
    names = {m["name"] for m in spec.metrics_of(bench, CELL, per_layer=True)}
    assert set(READERS) <= names
    for other in ("l2_classic.sca1", "l2_likely.sca1", "l2_classic.fpa18", "exposure_lane.sca1"):
        assert not set(READERS) & {m["name"] for m in spec.metrics_of(bench, other, True)}


def test_every_pointing_has_its_own_solution(entry):
    """Pointing k calibrates exposure k mod 8 under a WCS of its own: no
    two maps alike, so a cache of maps would never hit."""
    assert entry.items == [0, 1, 2]
    assert [entry.config[k]["IN"] for k in entry.items] == [
        f"L1/sim_L1_F184_{k}_1.asdf" for k in range(3)]
    assert len({entry.config[k]["FITSWCS"] for k in entry.items}) == 3
    maps = [entry.reference(k)["area_factor"] for k in entry.items]
    for a, b in zip(maps, maps[1:]):
        assert np.abs(a / b - 1).max() > 1e-5


def test_entry_matches_the_reference_with_the_frozen_map(entry):
    """Each call makes its map from its sidecar (counted ``area_host``
    here) and gives the reference's tree bit for bit."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        outs = [entry.call(k) for k in entry.items]
    c = profiling.snapshot()["counters"]
    profiling.reset()
    assert c["area_host"] == 3 and "area_device" not in c
    for k, out in zip(entry.items, outs):
        assert isinstance(out["area_factor"], torch.Tensor)
        got = entry.numbers(out, entry.reference(k))
        assert got == {"exact_frac": 0.0, "maps_gap": 0.0, "area_gap": 0.0}, k


def test_the_control_fails_the_map(entry):
    """The reference with its map in float32 arithmetic (and its products
    one precision down) fails ``area_gap`` by decades."""
    lim = _limits()
    ref = entry.reference(1)
    got = entry.numbers(entry.control(1), ref)
    assert got["area_gap"] > 1e3 * lim["area_gap"], got


def test_a_neighbouring_pointings_map_fails(entry, monkeypatch):
    """The call served the next pointing's sidecar for its map: the tree
    moves by the maps' ratio, within ``maps_gap``, and ``area_gap`` fails."""
    lim = _limits()
    m = entry.l1_to_l2
    make = m.area_factor_from_config
    nxt = {entry.config[k]["FITSWCS"]: entry.config[k + 1]["FITSWCS"] for k in (0, 1)}
    monkeypatch.setattr(m, "area_factor_from_config", lambda config, nside, device=None: make(
        dict(config, FITSWCS=nxt[config["FITSWCS"]]), nside, device=device))
    for k in (0, 1):
        got = entry.numbers(entry.call(k), entry.reference(k))
        assert got["exact_frac"] == 0.0 and got["maps_gap"] <= lim["maps_gap"]
        assert got["area_gap"] > lim["area_gap"], (k, got)


def test_a_run_of_the_harness_is_correct(monkeypatch):
    """A traced run at 128^2 on the CPU: correct, every call made its map
    on the host, and the readers that need no card read."""
    before = set(harness.forbidden_modules())
    found = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules", lambda: sorted(set(found()) - before))
    result, rows = harness.run(CELL, SEED, 0.5, True, device="cpu", overrides=SMALL,
                               log=io.StringIO())
    assert result["correct"], rows
    assert {name for name, _, _ in rows} == {"exact_frac", "maps_gap", "area_gap"}
    got = result["metrics"]
    assert got["wcs.area_device_pct"]["value"] == 0.0
    assert got["wcs.area_span_ms"]["value"] > 0
    assert "wcs.area_device_ms" not in got  # no device trace off the card


def _canned(calls=4, span=True, counters=None):
    spans = {"host.calibrate": {"count": calls, "total_ms": 700.0, "self_ms": 0.0,
                                "minflt": 0, "sys_ms": 0.0}}
    if span:
        spans["host.area"] = {"count": calls, "total_ms": 60.0, "self_ms": 10.0,
                              "minflt": 0, "sys_ms": 0.0}
    return {"spans": spans, "gauges": {},
            "counters": {"area_device": 3, "area_host": 1} if counters is None else counters}


class _Dev:
    """A device summary with 2 traced calls and 9 ms under ``l1_to_l2.area``."""

    ncalls = 2

    def __init__(self, us=9000.0):
        self.us = us

    def stage_us(self, prefix=""):
        return self.us if "l1_to_l2.area".startswith(prefix) else 0.0


def _ctx(ncalls, dev=None):
    return SimpleNamespace(spans=SimpleNamespace(calls=[{}] * ncalls), dev=dev, kind="cpu",
                           shapes={})


@pytest.mark.parametrize("name,want", [("wcs.area_device_ms", 4.5),
                                       ("wcs.area_span_ms", 15.0),
                                       ("wcs.area_device_pct", 75.0)])
def test_wcs_readers_on_a_canned_snapshot(monkeypatch, name, want):
    from gpubench import program_spans

    read = spec.reader(name)
    monkeypatch.setattr(program_spans, "snapshot", lambda: _canned())
    assert read(_ctx(4, _Dev())) == pytest.approx(want)
    # the recorder saw other calls than the traced ones
    assert read(_ctx(3, _Dev())) is None
    assert read(SimpleNamespace(spans=None, dev=_Dev())) is None
    # a program without a recorder
    monkeypatch.setattr(program_spans, "snapshot", lambda: None)
    assert read(_ctx(4, _Dev())) is None


def test_wcs_readers_where_the_program_makes_no_map(monkeypatch):
    """A program with no area span, counters or range (the parent's),
    and a run off the card: None."""
    from gpubench import program_spans

    dev_ms, span_ms, pct = (spec.reader(n) for n in READERS)
    monkeypatch.setattr(program_spans, "snapshot",
                        lambda: _canned(span=False, counters={"h2d_bytes": 10}))
    assert [r(_ctx(4, _Dev(0.0))) for r in (dev_ms, span_ms, pct)] == [None, None, None]
    monkeypatch.setattr(program_spans, "snapshot", lambda: _canned())
    assert dev_ms(_ctx(4, None)) is None
