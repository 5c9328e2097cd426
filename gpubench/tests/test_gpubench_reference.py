"""The plain reference against the port's plain path, the control and
the planted faults, each through a whole run of the harness at 128^2 on
the CPU (the look for a card skipped)."""

import io

import numpy as np
import pytest
import torch
from conftest import SMALL

from gpubench import control, harness, spec
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2

SEED = 2**31 + 977


def run_small(cell, seed=SEED, seconds=0.5):
    return harness.run(cell, seed, seconds, False, device="cpu", overrides=SMALL,
                       log=io.StringIO())


@pytest.mark.parametrize("cell", ["l2_classic.sca1", "l2_likely.sca1"])
def test_reference_matches_the_ports_plain_path(cell):
    """Bit for bit: the frozen plain path against the port's plain path."""
    result, rows = run_small(cell)
    assert result["correct"], rows
    assert result["failed"] == 0 and result["attempted"] > 0
    assert all(v == 0.0 for _, v, _ in rows)
    assert set(result["metrics"]) == {"sca_per_s", "sca_p90_ms", "setup_s"}


@pytest.mark.parametrize("cell", ["l2_classic.sca1", "l2_likely.sca1"])
def test_control_is_not_correct(cell):
    """The reference in TF32 (emulated on the CPU) in the program's place
    fails the cell's limits on every seed tried."""
    out = control.readings(cell, [5, 2**31 + 11], 2, "cpu", overrides=SMALL)
    lim = spec.limits(spec.cell(spec.benchmark(), cell)["config"])
    for seed, r in out.items():
        assert all(v == 0.0 for v in r["program"].values()), (seed, r)
        ok, rows = harness.compare.judge(r["control"], lim)
        assert not ok, (seed, rows)


def _ipc_unchanged(monkeypatch):
    """A step that returns its state unchanged: the IPC inverse."""
    monkeypatch.setattr(l1_to_l2, "_ipc", lambda s, route: None)


def _half_rows(monkeypatch):
    """Half of the frame's rows left out, filled with the mean of the rest."""
    make_core = l1_to_l2.make_core

    def broken(plan, cfg, geom):
        core = make_core(plan, cfg, geom)

        def run(arr):
            out = core(arr)
            for k in ("slope", "slope_withsky", "slope_err_read", "slope_err_poisson"):
                v = out[k].clone()
                h = v.shape[0] // 2
                v[h:] = v[:h].mean()
                out[k] = v
            return out
        return run

    monkeypatch.setattr(l1_to_l2, "make_core", broken)


def _value_altered(monkeypatch):
    """One answer altered where it is produced: the largest slope x 1.5."""
    to_host = l1_to_l2.to_host

    def broken(out):
        host = to_host(out)
        s = host["slope"]
        s.flat[np.argmax(np.abs(s))] *= 1.5
        return host

    monkeypatch.setattr(l1_to_l2, "to_host", broken)


def _dq_altered(monkeypatch):
    """One answer altered where it is produced: a DQ bit of one pixel."""
    to_host = l1_to_l2.to_host

    def broken(out):
        host = to_host(out)
        host["pdq"] = host["pdq"].copy()
        host["pdq"][64, 64] ^= np.uint32(1 << 2)
        return host

    monkeypatch.setattr(l1_to_l2, "to_host", broken)


@pytest.mark.parametrize("plant", [_ipc_unchanged, _half_rows, _value_altered, _dq_altered])
@pytest.mark.parametrize("cell", ["l2_classic.sca1", "l2_likely.sca1"])
def test_planted_fault_is_not_correct(cell, plant, monkeypatch):
    plant(monkeypatch)
    result, rows = run_small(cell)
    assert not result["correct"], rows
    assert result["failed"] == 0


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(__import__("sys").modules, "jaxlib_lookalike", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(__import__("sys").modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


@pytest.mark.cuda
def test_reference_matches_the_kernels_on_the_card(cuda_card):
    """On the card the port's kernels against the frozen plain path."""
    result, rows = harness.run("l2_classic.sca1", SEED, 1.0, False, device="cuda",
                               overrides={"nside": 512, "channelwidth": 16},
                               log=io.StringIO())
    assert result["correct"], rows
    assert torch.cuda.max_memory_allocated() > 0
