"""Finding a cell's files by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and
each metric; the files are found by those names alone:

- a configuration: ``gpubench/configs/<config>.json``, and the limits of
  its comparison ``gpubench/limits/<config>.json``; the configuration
  names its entry, ``gpubench/entries/<entry>.py`` (:mod:`.harness`
  says what an entry gives);
- a traffic mix: ``gpubench/traffic/<traffic>.json``;
- a per-layer metric: a reader ``gpubench/metrics/<name>.py`` with a
  function ``read(ctx)`` that returns the number, or None where it finds
  nothing to read.

So a later change adds a cell, a configuration, a mix or a metric as new
files and entries, and edits no file that is there.
"""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def cell(bench, workload):
    """The ``workloads`` entry named ``workload``."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(name, here=HERE):
    return load_json(Path(here) / "configs" / f"{name}.json")


def limits(name, here=HERE):
    return load_json(Path(here) / "limits" / f"{name}.json")


def traffic(name, here=HERE):
    return load_json(Path(here) / "traffic" / f"{name}.json")


def _module(kind, name, here):
    path = Path(here) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_{kind}_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name, here=HERE):
    """The ``read`` function of the metric ``name``."""
    return _module("metrics", name, here).read


def entry(name, here=HERE):
    """The entry module ``name``."""
    return _module("entries", name, here)


def metrics_of(bench, workload, per_layer):
    """The metric entries that ``workload`` reports: its end-to-end ones,
    or (``per_layer``) its per-layer ones; an entry with ``workloads``
    applies to those cells only."""
    group = bench["per_layer"] if per_layer else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]
