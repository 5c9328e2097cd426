"""The metric arithmetic on a canned trace and canned spans: the idle
union (kernels alone), the device time under the port's ranges, the
copies' time, the staged bytes, the roofline bytes, and the readers'
silence where nothing was traced."""

from types import SimpleNamespace

import pytest

from gpubench import roofline, spec, trace
from gpubench.spans import Spans

KIND = "NVIDIA H100 80GB HBM3"
RANGES = "l1_to_l2."


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def canned():
    """Two calls of 100 us; stages on the host, kernels launched in them.
    Call 1 [0, 100]: linearity [10, 30) launches k1 (dur 10 at 20) and a
    memcpy HtoD of 1000 bytes; ipc [30, 50) launches k2 (dur 20 at 35,
    overlapping k1 by nothing). Call 2 [200, 300]: linearity launches k1
    (dur 10 at 215); k3 has no launch record and lies in the device-side
    copy of the ipc range [230, 260) (dur 5 at 240)."""
    return [
        _x("user_annotation", "gpubench.call", 0, 100),
        _x("user_annotation", "gpubench.prepare_inputs", 0, 10),
        _x("user_annotation", "l1_to_l2.linearity", 10, 20),
        _x("user_annotation", "l1_to_l2.ipc", 30, 20),
        _x("user_annotation", "gpubench.package_tree", 60, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        _x("cuda_runtime", "cudaMemcpyAsync", 13, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=3),
        _x("kernel", "k1", 20, 10, correlation=1),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 14, 4, correlation=2, bytes=1000),
        _x("kernel", "k2", 35, 20, correlation=3),
        _x("user_annotation", "gpubench.call", 200, 100),
        _x("user_annotation", "l1_to_l2.linearity", 210, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 211, 1, correlation=4),
        _x("kernel", "k1", 215, 10, correlation=4),
        _x("gpu_user_annotation", "l1_to_l2.ipc", 230, 30),
        _x("kernel", "k3", 240, 5, correlation=99),
    ]


def test_device_summary():
    d = trace.Device(canned(), RANGES)
    assert d.ncalls == 2 and d.window == (0, 300)
    # kernels: [20,30) [35,55) [215,225) [240,245); the copy [14,18) apart
    assert d.busy() == [[20, 30], [35, 55], [215, 225], [240, 245]]
    assert d.busy_us() == pytest.approx(45)
    assert d.busy_us(trace.DEVICE_CATS) == pytest.approx(49)
    assert d.copy_us() == pytest.approx(4)
    assert d.stage_us() == pytest.approx(4 + 10 + 20 + 10 + 5)
    assert d.stage_us("l1_to_l2.linearity") == pytest.approx(24)
    assert d.stage_us("l1_to_l2.ipc") == pytest.approx(25)
    assert d.h2d_bytes() == 1000
    assert dict(d.top_ops()) == pytest.approx(
        {"k1": 20e-6, "k2": 20e-6, "k3": 5e-6, "Memcpy HtoD (Pageable -> Device)": 4e-6})
    idle = dict(d.idle_by_host())
    assert idle["prepare_inputs"] == pytest.approx(10e-6)  # [0, 10)
    assert idle["package_tree"] == pytest.approx(40e-6)  # [60, 100)
    # [10, 20), [30, 35), [55, 60), [200, 215), [225, 240), [245, 300)
    assert idle["call"] == pytest.approx((10 + 5 + 5 + 15 + 15 + 55) * 1e-6)
    assert idle["between calls"] == pytest.approx(100e-6)
    assert sum(idle.values()) == pytest.approx(300e-6 - 45e-6)


def test_readers_on_the_canned_trace():
    d = trace.Device(canned(), RANGES)
    s = Spans()
    for prep, stg, th, pk in ((0.010, 0.004, 0.002, 0.020), (0.012, 0.002, 0.002, 0.024)):
        s.begin()
        s._open.update({"prepare_inputs": prep, "staging_in_prepare_inputs": stg, "staging": stg,
                        "to_host": th, "package_tree": pk, "typefix.fix": 0.001})
        s.end()
    ctx = SimpleNamespace(spans=s, dev=d, kind=KIND,
                          shapes=dict(ngrp=8, nside=4096, ncoef=7))
    read = {m["name"]: spec.reader(m["name"])(ctx) for m in spec.benchmark()["per_layer"]}
    assert read["host.prepare_ms"] == pytest.approx(8.0)
    assert read["host.package_ms"] == pytest.approx(2 + 22 + 1)
    assert read["staging.ms"] == pytest.approx(3.0)
    assert read["staging.h2d_mb"] == pytest.approx(1000 / 2 / 1e6)
    assert read["core.device_ms"] == pytest.approx(49e-3 / 2)
    assert read["device.idle_pct"] == pytest.approx(100 * (1 - 45 / 300))
    assert read["device.copy_ms"] == pytest.approx(4e-3 / 2)
    lin = roofline.linearity_bytes(8, 4096, 4096, 7)
    assert read["kernels.linearity_roofline_pct"] == pytest.approx(
        100 * lin / 3.35e12 / 12e-6)
    ipc = roofline.ipc_bytes(8, 4096)
    assert read["kernels.ipc_roofline_pct"] == pytest.approx(100 * ipc / 3.35e12 / 12.5e-6)


def test_readers_are_silent_without_a_trace():
    ctx = SimpleNamespace(spans=Spans(), dev=None, kind="cpu",
                          shapes=dict(ngrp=8, nside=128, ncoef=7))
    for m in spec.benchmark()["per_layer"]:
        assert spec.reader(m["name"])(ctx) is None, m["name"]


def test_roofline_bytes():
    # 4096^2, 8 groups, order 6: frozen from the port's bytes_moved
    assert roofline.linearity_bytes(8, 4096, 4096, 7) == 4096**2 * (32 + 28 + 16 + 8 + 32 + 4)
    assert roofline.ipc_bytes(8, 4096) == 4 * 4096**2 * 26
    assert roofline.roofline_pct(3.35e9, 2e-3, KIND) == pytest.approx(50.0)
    assert roofline.roofline_pct(1, 1, "cpu") is None


def test_spans_count_nested_staging_once():
    s = Spans(groups={"stage": "staging", "ipc_precal": "staging"}, inside="prepare_inputs")
    inner = s.wrap("stage", lambda: None)
    outer = s.wrap("ipc_precal", lambda: inner())
    prep = s.wrap("prepare_inputs", lambda: (outer(), inner()))
    s.begin()
    prep()
    s.end()
    c = s.calls[0]
    assert c["staging"] == pytest.approx(c["staging_in_prepare_inputs"])
    assert 0 < c["staging"] <= c["prepare_inputs"]
