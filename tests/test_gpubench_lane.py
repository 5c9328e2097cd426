"""The benchmark's exposure lane (``exposure_lane.sca1``) on the CPU at
128^2: the plain reference against the port's plain lane, the control,
and the planted faults, each through a run of the harness (the look for
a card skipped), with the cell's limits."""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import control, harness, spec  # noqa: E402
from gpubench.entries import exposure_lane  # noqa: E402
from romanimpreprocess_tpu_torch.pipeline import noise, noise_core  # noqa: E402

CELL = "exposure_lane.sca1"
#: the benchmark's test size: 128^2 with the production channel count (32 of 4)
SMALL = {"nside": 128, "channelwidth": 4}
SEEDS = (2**31 + 977, 5)


def run_small(seed=SEEDS[0], seconds=0.5):
    return harness.run(CELL, seed, seconds, False, device="cpu", overrides=SMALL,
                       log=io.StringIO())


@pytest.fixture(autouse=True)
def _jax_of_other_tests(monkeypatch):
    """This process imports JAX for the other tests' oracle (the suite's
    conftest); a run may load no forbidden module beyond those.  A run
    in a process of its own: :func:`test_a_run_of_its_own_loads_no_jax`."""
    before = set(harness.forbidden_modules())
    found = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules", lambda: sorted(set(found()) - before))


def limits():
    return spec.limits(spec.cell(spec.benchmark(ROOT), CELL)["config"])


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_matches_the_ports_plain_lane(seed):
    """The frozen plain lane draws what the port draws and computes what
    it computes: every number reads 0, and the run is correct."""
    result, rows = run_small(seed)
    assert result["correct"], rows
    assert result["failed"] == 0 and result["attempted"] > 0
    assert {name for name, _, _ in rows} == set(limits())
    assert all(v == 0.0 for _, v, _ in rows), rows
    assert set(result["metrics"]) == {"sca_per_s", "sca_p90_ms", "setup_s"}
    assert not harness.forbidden_modules()


def test_a_run_of_its_own_loads_no_jax():
    """The harness in a fresh interpreter: correct, and neither JAX nor the
    JAX package loaded after the run."""
    code = (
        "import io, json, sys; sys.path.insert(0, '.'); from gpubench import harness; "
        f"r, rows = harness.run({CELL!r}, {SEEDS[1]}, 0.5, False, device='cpu', "
        f"overrides={SMALL!r}, log=io.StringIO()); "
        "print(json.dumps([r['correct'], harness.forbidden_modules(), rows]))")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, found, rows = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct, rows
    assert found == []


def test_control_is_not_correct():
    """The reference one precision below float32 (TF32 products and
    contractions, the ramp fit's cube in bfloat16) in the program's place
    fails the cell's limits on every seed tried."""
    out = control.readings(CELL, list(SEEDS), 1, "cpu", overrides=SMALL,
                           log=io.StringIO())
    for seed, r in out.items():
        assert all(v == 0.0 for v in r["program"].values()), (seed, r)
        ok, rows = harness.compare.judge(r["control"], limits())
        assert not ok, (seed, rows)


def _drop_o(monkeypatch):
    """The 'O' layers' Pearson draw left out."""
    monkeypatch.setattr(noise_core._Stages, "o_layer",
                        lambda self, gen, endslice, withsky, gain:
                        torch.zeros((self.na, self.na)))


def _p_from_one_read(monkeypatch):
    """'P...r' resampled from one Poisson draw repeated over the reads,
    not a draw per raw read."""
    def one_read(gen, e_exp, gain, endslice, read_pattern, weightvecs, ngrp, contract="dot"):
        nreads = read_pattern[-1][-1] + 1
        inc = noise.rand.poisson(gen, e_exp)
        incs = inc.expand((nreads,) + tuple(e_exp.shape)).contiguous()
        return noise.resample_increments(incs, e_exp, gain, endslice, read_pattern,
                                         weightvecs, ngrp, contract=contract)

    monkeypatch.setattr(noise, "resample_traced", one_read)


def _skip_trailing_s(monkeypatch):
    """The layers' trailing 'S' medfit subtraction left out."""
    monkeypatch.setattr(noise_core, "_subtract_medfit", lambda diff, order, med: diff)


def _wrong_stream(monkeypatch):
    """Each layer draws from another layer's streams."""
    layer_stream = noise_core.layer_stream
    monkeypatch.setattr(noise_core, "layer_stream",
                        lambda seed, i, comp, dev: layer_stream(seed, i + 1, comp, dev))


def _skip_zclip(monkeypatch):
    """The 'R' difference's IQR z-clip left out."""
    r_cal_diff = noise_core._Stages.r_cal_diff
    monkeypatch.setattr(noise_core._Stages, "r_cal_diff",
                        lambda self, arrs, orig, zclip=None, sky_order=None:
                        r_cal_diff(self, arrs, orig, None, sky_order))


def _gaussian_for_pearson(monkeypatch):
    """The 'O' draw from a normal of the Pearson's variance, in place of
    the Pearson family that carries its skewness and tails."""
    def normal(gen, t21, t31, t41, gI):
        gI = torch.clamp(gI, min=0.01)
        var = torch.clamp(torch.as_tensor(t21, dtype=torch.float32) * gI, min=0.0)
        return torch.sqrt(var) * noise_core.rand.normal(gen, tuple(gI.shape))

    monkeypatch.setattr(noise_core, "draw_from_pearson_torch", normal)


@pytest.mark.parametrize("fault", [_drop_o, _p_from_one_read, _skip_trailing_s,
                                   _wrong_stream, _skip_zclip, _gaussian_for_pearson])
def test_planted_fault_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(harness, "card_line", lambda: None)
    fault(monkeypatch)
    result, rows = run_small()
    assert not result["correct"], (fault.__name__, rows)


def test_noise_seed_follows_the_production_lattice():
    """Exposure e of SCA task 1 gets batch.plan_jobs' noise seed."""
    from romanimpreprocess_tpu_torch.pipeline import batch

    seed = 2**31 + 977
    _, jobs = batch.plan_jobs([(f"in_{e}.fits", "F184", e, exposure_lane.SCA)
                               for e in range(3)], output_dir="o", cal_dir="c", tag="T",
                              seed=seed, dseed=10, temp_dir="t")
    assert [c2["NOISE"]["SEED"] for _, c2 in jobs] == [
        exposure_lane.noise_seed(seed, e) for e in range(3)]


def test_census_counts_the_lanes_steps(monkeypatch, tmp_path):
    """The census the kernel shares count (fills, cores, contractions,
    medfits) is what one call of the port runs."""
    from romanimpreprocess_tpu_torch.ops import sky
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, sim_to_l1

    cfg = dict(spec.config("exposure_lane"), **SMALL)
    entry = exposure_lane.Entry(cfg, {"exposures": 1}, SEEDS[1], torch.device("cpu"),
                                tmp_path)
    seen = {"fills": 0, "cores": 0, "contractions": 0, "medfits": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            seen[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(sim_to_l1, "fill_in_refdata_and_1f",
                        counting("fills", sim_to_l1.fill_in_refdata_and_1f))
    monkeypatch.setattr(l1_to_l2, "calibrate_rows",
                        counting("cores", l1_to_l2.calibrate_rows))
    monkeypatch.setattr(torch, "einsum", counting("contractions", torch.einsum))
    monkeypatch.setattr(sky, "medfit", counting("medfits", sky.medfit))
    entry._build()
    entry.call(0)
    assert seen == {k: entry.shapes[k] for k in seen}


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _lane_trace():
    """One call of 1000 us: each range launches one kernel of ``dur``."""
    stages = [("sim_to_l1.poisson", "poisson_k", 40), ("sim_to_l1.contract", "gemm", 20),
              ("sim_to_l1.fill.pink", "pink_stage1", 30), ("l1_to_l2.ramp_fit", "fit", 50),
              ("noise.contract", "gemm", 20), ("noise.medfit", "block_nanmedian_cluster", 5),
              ("noise.stack", "cat", 10)]
    ev = [_x("user_annotation", "gpubench.call", 0, 1000)]
    for i, (name, kernel, dur) in enumerate(stages):
        t = 10 + 100 * i
        ev += [_x("user_annotation", name, t, 90),
               _x("cuda_runtime", "cudaLaunchKernel", t + 1, 1, correlation=i),
               _x("kernel", kernel, t + 5, dur, correlation=i)]
    return ev


def test_lane_readers_on_a_canned_trace():
    """The lane's readers: the four device times partition the ranges'
    time, the shares read the census against the kernels' or ranges'
    time, and a trace without the lane's ranges reads nothing."""
    from types import SimpleNamespace

    from gpubench import lane_readers, lane_roofline, roofline, trace

    kind = "NVIDIA H100 80GB HBM3"
    shapes = dict(ngrp=8, nside=4096, na=4088, nreads=35, channelwidth=128, fills=9,
                  cores=10, contractions=5, medfits=22)
    ctx = SimpleNamespace(spans=None, kind=kind, shapes=shapes,
                          dev=trace.Device(_lane_trace(), exposure_lane.RANGES))
    assert lane_readers.sim_device_ms(ctx) == pytest.approx(60e-3)
    assert lane_readers.fill_device_ms(ctx) == pytest.approx(30e-3)
    assert lane_readers.cores_device_ms(ctx) == pytest.approx(50e-3)
    assert lane_readers.layers_device_ms(ctx) == pytest.approx(35e-3)
    assert ctx.dev.stage_us() == pytest.approx(175)
    ops = 9 * lane_roofline.pink_flops(8 * 34 // 2, 2 * 4096 * 128)
    assert lane_readers.pink_roofline_pct(ctx) == pytest.approx(100 * ops / 989e12 / 30e-6)
    nbytes = 5 * lane_roofline.contract_bytes(8, 35, 4088, 4088)
    assert lane_readers.contract_roofline_pct(ctx) == pytest.approx(
        roofline.roofline_pct(nbytes, 40e-6, kind))
    nbytes = 22 * lane_roofline.blockmed_bytes(4088, 4088, 8)
    assert lane_readers.blockmed_roofline_pct(ctx) == pytest.approx(
        roofline.roofline_pct(nbytes, 5e-6, kind))
    other = [e for e in _lane_trace() if not e["name"].startswith(("sim_to_l1.", "noise."))]
    bare = SimpleNamespace(spans=None, kind=kind, shapes=shapes,
                           dev=trace.Device(other, exposure_lane.RANGES))
    for read in (lane_readers.sim_device_ms, lane_readers.fill_device_ms,
                 lane_readers.layers_device_ms, lane_readers.contract_roofline_pct,
                 lane_readers.draws_m, lane_readers.d2h_mb):
        assert read(bare) is None, read.__name__
    l2_shapes = SimpleNamespace(spans=None, kind=kind, dev=ctx.dev,
                                shapes=dict(ngrp=8, nside=4096, ncoef=7))
    assert lane_readers.pink_roofline_pct(l2_shapes) is None


def test_lane_program_span_readers(monkeypatch):
    """The recorder's readers divide by the ``host.lane`` count, and read
    nothing where it is not the traced calls' count."""
    from types import SimpleNamespace

    from gpubench import lane_readers

    snap = {"spans": {"host.lane": {"count": 2, "total_ms": 3000.0, "sys_ms": 50.0},
                      "l1_to_l2.ramp_fit": {"count": 20, "total_ms": 30.0, "sys_ms": 0.0},
                      "l1_to_l2.sky": {"count": 20, "total_ms": 10.0, "sys_ms": 0.0},
                      "host.noise.to_host": {"count": 2, "total_ms": 500.0, "sys_ms": 40.0}},
            "counters": {"rng_draws": 4e6, "d2h_bytes": 2e6}}
    monkeypatch.setattr(lane_readers, "snapshot", lambda: snap)
    ctx = SimpleNamespace(spans=SimpleNamespace(calls=[{}, {}]))
    assert lane_readers.core_host_ms(ctx) == pytest.approx(20.0)
    assert lane_readers.sys_ms(ctx) == pytest.approx(25.0)
    assert lane_readers.draws_m(ctx) == pytest.approx(2.0)
    assert lane_readers.d2h_mb(ctx) == pytest.approx(1.0)
    ctx3 = SimpleNamespace(spans=SimpleNamespace(calls=[{}, {}, {}]))
    for read in (lane_readers.core_host_ms, lane_readers.sys_ms, lane_readers.draws_m,
                 lane_readers.d2h_mb):
        assert read(ctx3) is None, read.__name__


@pytest.mark.parametrize("call_span", ["host.calibrate", "host.lane"])
def test_pinned_share_reader(monkeypatch, call_span):
    """``host.d2h_pinned_pct`` reads the pinned share of the copy back over
    the traced calls of either entry; nothing where the counter is absent
    (a program without it) or the calls do not match."""
    from types import SimpleNamespace

    from gpubench import program_spans

    snap = {"spans": {call_span: {"count": 2, "total_ms": 900.0, "sys_ms": 0.0}},
            "counters": {"d2h_bytes": 4e6, "d2h_pinned_bytes": 3e6}}
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    read = spec.reader("host.d2h_pinned_pct")
    two = SimpleNamespace(spans=SimpleNamespace(calls=[{}, {}]))
    assert read(two) == pytest.approx(75.0)
    assert read(SimpleNamespace(spans=SimpleNamespace(calls=[{}, {}, {}]))) is None
    assert read(SimpleNamespace(spans=None)) is None
    del snap["counters"]["d2h_pinned_bytes"]
    assert read(two) is None


@pytest.mark.parametrize("call_span", ["host.calibrate", "host.lane"])
def test_h2d_pinned_share_reader(monkeypatch, call_span):
    """``staging.h2d_pinned_pct`` reads the share of the copies to the
    device that went through page-locked memory over the traced calls of
    either entry: 100, a part, and nothing where the counter is absent (a
    program without it) or the calls do not match."""
    from types import SimpleNamespace

    from gpubench import program_spans

    snap = {"spans": {call_span: {"count": 2, "total_ms": 900.0, "sys_ms": 0.0}},
            "counters": {"h2d_bytes": 4e6, "h2d_pinned_bytes": 4e6}}
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    read = spec.reader("staging.h2d_pinned_pct")
    two = SimpleNamespace(spans=SimpleNamespace(calls=[{}, {}]))
    assert read(two) == pytest.approx(100.0)
    snap["counters"]["h2d_pinned_bytes"] = 1e6
    assert read(two) == pytest.approx(25.0)
    assert read(SimpleNamespace(spans=SimpleNamespace(calls=[{}, {}, {}]))) is None
    assert read(SimpleNamespace(spans=None)) is None
    del snap["counters"]["h2d_pinned_bytes"]
    assert read(two) is None
