"""The per-layer metrics that read the program's own recorder.

The port's ``utils.profiling`` records spans (count, wall and self ms,
minor page faults, system CPU ms) and counters while a ``torch.profiler`` records: in
a traced run, exactly over the traced calls.  Each reader divides by the
count of ``host.calibrate`` spans (one a call of ``calibrate_tree``) and
returns None where there is nothing to read: no recorder in the program
(:func:`snapshot` None), no ``host.calibrate`` span, or a count other
than the traced calls' (``len(ctx.spans.calls)``).

What the readers assume of the program's spans: the staging spans
(``host.stage``, ``host.ipc_precal``, ``host.kernel_planes``) hold no
span but staging spans, so their self times sum to the time inside the
outermost of them; every staging span of a call lies inside
``host.prepare``; ``l1_to_l2.<stage>`` spans do not nest.
"""

#: spans that stage arrays onto the device
STAGING = ("host.stage", "host.ipc_precal", "host.kernel_planes")
#: host-driver spans whose minor page faults and system CPU time are read
FAULTING = ("host.prepare", "host.to_host", "host.package", "host.typefix")
#: caches of the staging
STAGING_CACHES = ("device_arrays", "ipc_precal", "kernel_planes")
#: the core's device-stage spans start with this
CORE = "l1_to_l2."


def snapshot():
    """The program's recorder's snapshot, or None where it has none."""
    try:
        from romanimpreprocess_tpu_torch.utils import profiling
    except ImportError:
        return None
    snap = getattr(profiling, "snapshot", None)
    return snap() if callable(snap) else None


def _read(ctx):
    """(snapshot, calls) where the recorder saw exactly the traced calls,
    else None."""
    snap = snapshot()
    if not snap:
        return None
    n = snap.get("spans", {}).get("host.calibrate", {}).get("count", 0)
    calls = len(ctx.spans.calls) if ctx.spans is not None else 0
    if n == 0 or n != calls:
        return None
    return snap, n


def _sum(snap, names, key="total_ms"):
    spans = snap["spans"]
    return sum(spans[k][key] for k in names if k in spans)


def _counter_per_call(ctx, name, scale):
    got = _read(ctx)
    if got is None or name not in got[0]["counters"]:
        return None
    snap, n = got
    return snap["counters"][name] / n / scale


def host_prepare_span_ms(ctx):
    """Wall ms of ``host.prepare`` per SCA, less the staging inside it."""
    got = _read(ctx)
    if got is None or "host.prepare" not in got[0]["spans"]:
        return None
    snap, n = got
    return (_sum(snap, ["host.prepare"]) - _sum(snap, STAGING, "self_ms")) / n


def host_package_span_ms(ctx):
    """Wall ms of ``host.to_host`` + ``host.package`` + ``host.typefix`` per SCA."""
    got = _read(ctx)
    if got is None or "host.package" not in got[0]["spans"]:
        return None
    snap, n = got
    return _sum(snap, ("host.to_host", "host.package", "host.typefix")) / n


def staging_span_ms(ctx):
    """Wall ms inside the staging spans per SCA, nested ones once."""
    got = _read(ctx)
    if got is None:
        return None
    snap, n = got
    return _sum(snap, STAGING, "self_ms") / n


def staging_staged_mb(ctx):
    """MB the host driver sends to the device per SCA (``h2d_bytes``)."""
    return _counter_per_call(ctx, "h2d_bytes", 1e6)


def staging_hit_pct(ctx):
    """Share (%) of the staging caches' lookups that hit."""
    got = _read(ctx)
    if got is None:
        return None
    c = got[0]["counters"]
    hit = sum(c.get(f"cache.{k}.hit", 0) for k in STAGING_CACHES)
    miss = sum(c.get(f"cache.{k}.miss", 0) for k in STAGING_CACHES)
    return 100.0 * hit / (hit + miss) if hit + miss else None


def host_d2h_mb(ctx):
    """MB ``to_host`` copies back from the device per SCA (``d2h_bytes``)."""
    return _counter_per_call(ctx, "d2h_bytes", 1e6)


def host_faults_k(ctx):
    """Thousands of minor page faults per SCA in the host driver's
    prepare, copy-back, packaging and type-fix spans."""
    got = _read(ctx)
    if got is None:
        return None
    snap, n = got
    return _sum(snap, FAULTING, "minflt") / n / 1e3


def host_sys_ms(ctx):
    """System CPU ms per SCA in the same spans as :func:`host_faults_k`:
    the kernel's time faulting in and zeroing fresh host buffers, where
    it counts no faults."""
    got = _read(ctx)
    if got is None:
        return None
    snap, n = got
    return _sum(snap, FAULTING, "sys_ms") / n


def core_host_ms(ctx):
    """Host wall ms per SCA inside the core's ``l1_to_l2.<stage>`` spans
    (launches, and any wait for the device inside the core)."""
    got = _read(ctx)
    if got is None:
        return None
    snap, n = got
    core = [k for k in snap["spans"] if k.startswith(CORE)]
    return _sum(snap, core) / n if core else None
