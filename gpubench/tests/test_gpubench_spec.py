"""Every cell of BENCHMARK.json resolves to its files by name, the file
keeps to the contract's shape, and a new cell needs only new files."""

import hashlib
import io
import json
import re
import shutil

import pytest
from conftest import ROOT, SMALL

from gpubench import harness, spec
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2

BENCH = spec.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    wl = spec.cell(BENCH, cell)
    cfg = spec.config(wl["config"])
    ent = spec.entry(cfg["entry"])
    ent.check(cfg)
    assert callable(ent.load) and isinstance(ent.RANGES, str)
    mix = spec.traffic(wl["traffic"])
    assert {"warm_calls", "trace_calls", "sample"} <= set(mix)
    lim = spec.limits(wl["config"])
    assert lim and all(isinstance(v, (int, float)) for v in lim.values())
    for per_layer in (False, True):
        metrics = spec.metrics_of(BENCH, cell, per_layer)
        assert metrics
        for m in metrics:
            if per_layer:
                assert callable(spec.reader(m["name"]))
    assert any(m["name"] == "setup_s" for m in spec.metrics_of(BENCH, cell, False))


def test_names_units_and_bounds():
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert spec.config(c["name"]) == json.loads((ROOT / c["file"]).read_text())
    seen = set()
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["name"] not in seen
            seen.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200


def _digest(d):
    return {p.relative_to(d): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _dummy_checkout(tmp_path, program):
    """A copy of the benchmark's files with a dummy configuration (the
    classic one with ``program`` keys added), limits, mix and metric as
    new files, and their new entries in BENCHMARK.json."""
    here = tmp_path / "gpubench"
    for sub in ("configs", "traffic", "metrics", "limits", "entries"):
        shutil.copytree(ROOT / "gpubench" / sub, here / sub)
    before = _digest(here)
    cfg = spec.config("l2_classic")
    cfg = dict(cfg, program=dict(cfg["program"], **program))
    (here / "configs" / "l2_dummy.json").write_text(json.dumps(cfg))
    (here / "limits" / "l2_dummy.json").write_text(json.dumps(spec.limits("l2_classic")))
    (here / "traffic" / "sca2.json").write_text(json.dumps(
        dict(spec.traffic("sca1"), scas=2, exposures=1)))
    (here / "metrics" / "dummy.calls.py").write_text(
        "def read(ctx):\n    return len(ctx.spans.calls) if ctx.spans else None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "l2_dummy.sca2", "config": "l2_dummy",
                               "traffic": "sca2", "chips": 1, "why": "dummy"})
    bench["per_layer"].append({"name": "dummy.calls", "unit": "calls", "better": "higher",
                               "source": "program_span", "layer": "host driver",
                               "moves": "sca_per_s", "workloads": ["l2_dummy.sca2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return here, bench, before


#: program keys that no configuration of the benchmark has set so far
NEW_KEYS = {"SATURATION_BACKUP": 0, "EXCLUDE_FIRST": False, "SKY_BACKEND": "xla"}


def test_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    """A dummy configuration, mix and metric, added as new files and
    entries, resolve and run without a change to any file that was there,
    and every key of the configuration's ``program`` object reaches the
    program."""
    here, bench, before = _dummy_checkout(tmp_path, NEW_KEYS)
    wl = spec.cell(bench, "l2_dummy.sca2")
    assert spec.traffic(wl["traffic"], here)["scas"] == 2
    assert spec.limits(wl["config"], here) == spec.limits("l2_classic")
    names = [m["name"] for m in spec.metrics_of(bench, "l2_dummy.sca2", True)]
    assert "dummy.calls" in names
    assert "dummy.calls" not in [m["name"] for m in spec.metrics_of(bench, "l2_classic.sca1",
                                                                      True)]
    read = spec.reader("dummy.calls", here)
    assert read(type("Ctx", (), {"spans": None})()) is None

    seen = []
    calibrate_tree = l1_to_l2.calibrate_tree

    def spy(l1, config, *args, **kwargs):
        seen.append(dict(config))
        return calibrate_tree(l1, config, *args, **kwargs)

    monkeypatch.setattr(l1_to_l2, "calibrate_tree", spy)
    result, rows = harness.run("l2_dummy.sca2", 2**31 + 5, 0.3, False, device="cpu",
                               root=tmp_path, overrides=SMALL, log=io.StringIO())
    assert result["correct"], rows
    assert seen and all(c[k] == v for c in seen for k, v in NEW_KEYS.items())
    after = _digest(here)
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("key", [{"JUMP_KW": {"sigma": 3.0}}, {"correct_wfi18_transient": True},
                                 {"FITSWCS": "elsewhere.txt"}])
def test_a_key_the_reference_does_not_honour_is_refused(tmp_path, key):
    """A ``program`` key that the reference does not honour, or one that
    each call sets, stops the run before set-up."""
    _dummy_checkout(tmp_path, key)
    with pytest.raises(ValueError, match=next(iter(key))):
        harness.run("l2_dummy.sca2", 1, 0.3, False, device="cpu", root=tmp_path,
                    overrides=SMALL, log=io.StringIO())
