"""One run of one cell: inputs from the seed, warm-up, the measured
window, the trace, the comparison with the plain reference.

The harness knows no entry of its own.  The cell's configuration file
names its entry (``"entry"``), a module ``gpubench/entries/<entry>.py``
found by name, which gives:

- ``check(cfg)``: ValueError where the configuration asks for what the
  reference cannot hold the program to (called before anything else);
- ``load()``: the program's modules (timed as the port's import);
- ``Entry(cfg, mix, seed, device, workdir)``: the inputs made from the
  seed, with ``items`` (the mix's sequence), ``describe()``,
  ``call(item)`` (the timed call, returning the program's output),
  ``install_spans(spans)`` (the traced run's host spans), ``shapes``
  (for the metric readers), ``free()`` (the program's state dropped),
  ``reference(item)``, ``control(item)`` and ``numbers(out, ref)``;
- ``RANGES``: the prefix of the program's device-stage ranges.

One caller makes one call after another (a closed loop) over the items.
:func:`run` returns the result line and the compared numbers; ``run.py``
checks for the card and prints them.
"""

import gc
import os
import resource
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import compare, roofline, spec, trace
from .spans import Spans

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "romanimpreprocess_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is forbidden (whole names)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line():
    """The card's name and power limit from ``nvidia-smi``, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip() or None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reference_readings(entry, sample):
    """The compared numbers of each sampled (item, output), against the
    plain reference worked out again after the window."""
    out = []
    for item, tree in sample:
        ref = entry.reference(item)
        out.append(entry.numbers(tree, ref))
        del ref
        gc.collect()
    return out


def run(workload, seed, seconds, trace_on, *, device="cuda", root=spec.ROOT,
        overrides=None, t_start=None, log=sys.stderr):
    """One run of ``workload``, its files found under ``root``.  Returns
    (result dict, [(name, value, limit)]); ``overrides`` changes
    configuration keys (the tests' small sizes)."""
    t_begin = time.perf_counter()
    t_start = t_begin if t_start is None else t_start
    here = Path(root) / spec.HERE.name
    bench = spec.benchmark(root)
    wl = spec.cell(bench, workload)
    cfg = dict(spec.config(wl["config"], here), **(overrides or {}))
    mix = spec.traffic(wl["traffic"], here)
    lim = spec.limits(wl["config"], here)
    ent = spec.entry(cfg["entry"], here)
    ent.check(cfg)

    t0 = time.perf_counter()
    ent.load()
    t_import = time.perf_counter() - t0

    t0 = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
        _sync(dev)
    t_cuda = time.perf_counter() - t0

    t0 = time.perf_counter()
    workdir = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "gpubench" / workload
    entry = ent.Entry(cfg, mix, seed, dev, workdir)
    _sync(dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t_inputs = time.perf_counter() - t0

    spans = Spans() if trace_on else None
    if spans is not None:
        entry.install_spans(spans)
    call = entry.call

    items = entry.items
    warm = mix["warm_calls"]
    t0 = time.perf_counter()
    for i in range(warm):
        call(items[i % len(items)])
    _sync(dev)
    t_warm = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    print(f"setup_s {setup_s:.3f}: start-up {t_begin - t_start:.3f} s, port import "
          f"{t_import:.3f} s, cuda {t_cuda:.3f} s, "
          f"inputs {t_inputs:.3f} s ({entry.describe()}), "
          f"warm-up {t_warm:.3f} s ({warm} calls); host max RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB", file=log)

    # ---- the measured window ----
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 5])
    keep = mix["sample"]
    sample, lat = [], []
    attempted = failed = 0
    prof = None
    ntrace = mix["trace_calls"] if trace_on else 0
    if ntrace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    w0 = time.perf_counter()
    deadline = w0 + seconds
    traced_s = None
    while time.perf_counter() < deadline:
        item = items[(warm + attempted) % len(items)]
        tracing = prof is not None and attempted < ntrace
        c0 = time.perf_counter()
        try:
            if tracing:
                spans.begin()
                with torch.profiler.record_function("gpubench.call"):
                    tree = call(item)
                spans.end()
            else:
                tree = call(item)
        except Exception:  # a failed call is counted and reported, the window goes on
            failed += 1
            if failed == 1:
                traceback.print_exc(file=log)
            tree = None
        lat.append(time.perf_counter() - c0)
        attempted += 1
        done = attempted - failed
        if tree is not None:
            if len(sample) < keep:
                sample.append((item, tree))
            else:
                j = int(rng.integers(0, done))
                if j < keep:
                    sample[j] = (item, tree)
            del tree
        if prof is not None and attempted == ntrace:
            _sync(dev)
            traced_s = time.perf_counter() - w0
            prof.stop()
    w1 = time.perf_counter()
    if prof is not None and traced_s is None:
        _sync(dev)
        traced_s = time.perf_counter() - w0
        prof.stop()
    window = w1 - w0
    completed = attempted - failed

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    result = {
        "correct": False, "attempted": attempted, "failed": failed, "metrics": {},
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    lat_ms = np.array(lat) * 1e3
    print(f"window {window:.3f} s: {attempted} calls, {failed} failed; call ms "
          f"median {np.median(lat_ms) if lat else float('nan'):.2f}, "
          f"p90 {np.percentile(lat_ms, 90) if lat else float('nan'):.2f} "
          f"of {len(lat)} samples", file=log)

    if trace_on:
        dsum = None
        if prof is not None and dev.type == "cuda":
            tmp = workdir / "trace.json"
            dsum = trace.read_chrome_trace(prof, str(tmp), ent.RANGES)
        if spans is not None:
            spans.uninstall()
        ctx = SimpleNamespace(spans=spans, dev=dsum, kind=result["device"]["kind"],
                              shapes=entry.shapes)
        for m in spec.metrics_of(bench, workload, per_layer=True):
            v = spec.reader(m["name"], here)(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        print(f"rooflines against {roofline.peak(result['device']['kind'], 'hbm_bytes_per_s')} "
              f"B/s; card {card_line()}", file=log)
        if dsum is not None and dsum.window_us():
            result["device"]["busy_s"] = dsum.busy_us(trace.DEVICE_CATS) * 1e-6
            result["device"]["window_s"] = dsum.window_us() * 1e-6
            result["breakdown"] = {"device_ops": dsum.top_ops(),
                                   "idle_gaps": dsum.idle_by_host()}
            print(f"traced {dsum.ncalls} calls in {traced_s:.3f} s", file=log)
    else:
        values = {
            "sca_per_s": completed / window if window > 0 else None,
            "sca_p90_ms": float(np.percentile(lat_ms, 90)) if lat else None,
            "setup_s": setup_s,
        }
        for m in spec.metrics_of(bench, workload, per_layer=False):
            if values.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}

    # ---- the comparison, once the window has closed ----
    entry.free()
    t0 = time.perf_counter()
    readings = compare.worst(reference_readings(entry, sample))
    ok, rows = compare.judge(readings, lim)
    print(f"reference: {len(sample)} sampled calls "
          f"({', '.join(str(item) for item, _ in sample)}) "
          f"in {time.perf_counter() - t0:.3f} s", file=log)
    result["correct"] = bool(ok and failed == 0 and completed > 0)
    result["checks"] = {k: {"value": v, "limit": lim_} for k, v, lim_ in rows}
    return result, rows
