"""Kernel D's wrapper (``ops/invlin_cuda``) and its routing, on the CPU.

The kernel (``csrc/invlin.cu``) runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Held here: the
wrapper on CPU tensors is the plain path (``linearity.invert_linearity``
of ``x / gain`` on the centred active window) to the bit, and a tensor
on another device raises; ``IL`` and ``make_l1_fullcal`` route by
``lin_backend``; ``run_config`` and the exposure runner's sim pass the
resolved ``LIN_BACKEND``; the operation and byte counts at the
production lane's size.
"""

import numpy as np
import pytest
import torch

from romanimpreprocess_tpu_torch import benchlib, synth
from romanimpreprocess_tpu_torch.ops import invlin_cuda, linearity, rand
from romanimpreprocess_tpu_torch.pipeline import noise_core, sim_to_l1

torch.set_num_threads(1)

READ_PATTERN = synth.READ_PATTERN_DEFAULT


def _case(nside, ncoef, seed=0):
    """(gain, lin) full frames from ``synth`` at ``ncoef`` coefficients:
    its order-3 expansion cut, or extended by small higher orders (a few
    DN at the ends of the range, as the benchmark's packs)."""
    cal = synth.synth_cal_arrays(nside, READ_PATTERN, seed=seed)
    rng = np.random.RandomState(seed)
    coefs = cal["lin_coefs"]
    extra = rng.uniform(-5.0, 5.0, (max(ncoef - 4, 0), nside, nside))
    coefs = np.concatenate([coefs, extra.astype(np.float32)])[:ncoef]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    lin = linearity.LinearityData(
        t(coefs), t(cal["lin_smin"]), t(cal["lin_smax"]), t(cal["lin_sref"]),
        torch.from_numpy(cal["lin_dq"].view(np.int32)))
    return t(cal["gain"]), lin


def _x(shape, gain, nb, seed=1):
    """Linearized DN times the gain, from below the range (z saturates
    at -1) to above it (+1)."""
    rng = np.random.RandomState(seed)
    n = gain.shape[0]
    slin = torch.from_numpy(rng.uniform(-3000, 70000, shape).astype(np.float32))
    return slin * gain[nb:n - nb, nb:n - nb]


@pytest.mark.parametrize("ngrp,nside,nb,ncoef", [
    (None, 32, 0, 4),   # one 2-D frame, the whole calibration frame
    (3, 40, 4, 7),      # a batch in the border's window, order 6
    (2, 24, 2, 1),      # one coefficient: the expansion is constant
])
def test_wrapper_on_cpu_is_the_plain_path(ngrp, nside, nb, ncoef):
    gain, lin = _case(nside, ncoef)
    na = nside - 2 * nb
    x = _x((na, na) if ngrp is None else (ngrp, na, na), gain, nb)
    act = slice(nb, nside - nb)
    lin_act = linearity.LinearityData(*(a[..., act, act] for a in lin))
    n0 = invlin_cuda.launches
    got, ex_got = invlin_cuda.invert_linearity_fused(x, gain, lin)
    want, ex_want = linearity.invert_linearity(x / gain[act, act], lin_act)
    assert invlin_cuda.launches == n0  # the plain path launches nothing
    assert got.shape == x.shape and got.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(ex_got, ex_want)
    if ncoef > 1:
        # both domain edges reached: z within 2^-24 of -1 and of +1
        z = (got - lin_act.smin) / (lin_act.smax - lin_act.smin) * 2 - 1
        assert float(z.min()) < -1 + 1e-5 and float(z.max()) > 1 - 1e-5


@pytest.mark.parametrize("ncoef,niter,match", [(4, 24, "CUDA tensor"),
                                               (9, 24, "coefficients"),
                                               (4, 0, "steps")])
def test_wrapper_raises_off_the_cpu_and_the_card(ncoef, niter, match):
    meta = dict(device="meta")
    lin = linearity.LinearityData(
        torch.zeros((ncoef, 8, 8), **meta), torch.zeros((8, 8), **meta),
        torch.ones((8, 8), **meta), torch.zeros((8, 8), **meta),
        torch.zeros((8, 8), dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match=match):
        invlin_cuda.invert_linearity_fused(torch.zeros((2, 8, 8), **meta),
                                           torch.ones((8, 8), **meta), lin, niter)


@pytest.fixture
def spy(monkeypatch):
    """Counts the wrapper's calls and runs it."""
    calls = []
    real = invlin_cuda.invert_linearity_fused

    def fused(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(invlin_cuda, "invert_linearity_fused", fused)
    return calls


@pytest.mark.parametrize("ndim", [2, 3])
def test_il_routes_by_lin_backend(spy, ndim):
    gain, lin = _case(32, 7)
    na = 24
    rng = np.random.RandomState(ndim)
    counts = torch.from_numpy(rng.uniform(0, 60000, (4, na, na)[3 - ndim:]).astype(np.float32))
    K = torch.from_numpy(synth.synth_cal_arrays(32, READ_PATTERN)["ipc_kernel"])
    out = {}
    for b in ("xla", "cuda"):
        out[b] = sim_to_l1.IL(lin, gain, K, start_e=10.0, lin_backend=b).apply(counts)
        assert len(spy) == (b == "cuda")
    assert torch.equal(out["xla"], out["cuda"])


def test_make_l1_fullcal_routes_by_lin_backend(spy):
    _arr, _prep, pack = benchlib.exposure_bundle(nside=32, device="cpu")
    rate = np.full((24, 24), 400.0, np.float32)
    out = {}
    for b in ("xla", "cuda"):
        out[b] = sim_to_l1.make_l1_fullcal(
            rand.sim_generator(5, "cpu"), rate, READ_PATTERN, pack, crparam={},
            lin_backend=b)
        assert len(spy) == (b == "cuda")
    assert spy == [(len(READ_PATTERN), 24, 24)]
    for a, b in zip(out["xla"], out["cuda"]):
        assert torch.equal(a, b)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("value,want", [(None, "xla"), ("auto", "xla"), ("xla", "xla"),
                                        ("cuda", ValueError)])
def test_run_config_passes_resolved_lin_backend(tmp_path, monkeypatch, value, want):
    d = str(tmp_path)
    scene = synth.make_scene_file(d + "/truth_F184_163_4.fits", nside_active=24, nstars=2)
    caldir = synth.make_cal_files(d + "/cal", READ_PATTERN, nside=32, seed=5)
    seen = []

    def fullcal(*a, **k):
        seen.append(k["lin_backend"])
        raise _Stop

    monkeypatch.setattr(sim_to_l1, "make_l1_fullcal", fullcal)
    cfg = {"IN": scene, "OUT": d + "/L1.asdf", "CALDIR": caldir, "SEED": 3,
           "READS": [v for g in READ_PATTERN for v in (g[0], g[-1] + 1)]}
    if value is not None:
        cfg["LIN_BACKEND"] = value
    with pytest.raises(_Stop if want == "xla" else want):
        sim_to_l1.run_config(cfg, device="cpu")
    assert seen == ([want] if want == "xla" else [])


def test_exposure_sim_passes_the_preps_lin_backend(monkeypatch):
    arr, prep, pack = benchlib.exposure_bundle(nside=32, device="cpu")
    assert prep["kernels"].lin == prep["cfg"]["lin"] == "xla"  # LIN_BACKEND auto on the CPU
    seen = []
    real = sim_to_l1.make_l1_fullcal

    def fullcal(*a, **k):
        seen.append(k["lin_backend"])
        return real(*a, **k)

    monkeypatch.setattr(sim_to_l1, "make_l1_fullcal", fullcal)
    data = {}
    for b in ("xla", "cuda"):
        prep["kernels"] = prep["kernels"]._replace(lin=b)
        data[b] = noise_core._Stages(prep, pack).simulate(7, arr)["data"]
    assert seen == ["xla", "cuda"]
    assert torch.equal(data["xla"], data["cuda"])


def test_invlin_flops_and_bytes_at_lane_size():
    n = 4088 * 4088
    # x 534.8 MB, gain 66.8, coefficients 467.9, smin/smax 133.7 in;
    # S 534.8 and exflag 133.7 out: about 1.87 GB, 0.56 ms at 3.35 TB/s
    assert invlin_cuda.bytes_moved(8, 4088, 7) == n * (32 + 4 + 28 + 8 + 32 + 8)
    # 34 operations a step at 7 coefficients, 24 steps, 6 more a group
    # and 2 a pixel: about 110 G, 3.3 ms at 33.5 T unfused float32 a second
    ops = invlin_cuda.flops(8, 4088, 7)
    assert ops == n * (8 * (1 + 24 * 34 + 5) + 2)
    assert 3.2e-3 < ops / 33.5e12 < 3.4e-3
