"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA GPU and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is
not installed; ``tests/conftest.py`` imports JAX, so on such a machine
run it without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernels repeat their plain twins' rounded steps in the
same order (no FMA contraction), so linearity (cube and DQ), the block
nanmedian (every size branch: clusters of 1 to 8 CTAs and the streaming
kernel; also against ``np.nanmedian``), the L2 product maps made on the
card against the host numpy packaging (NaN by ``isnan``), the read contraction, the forward
IPC, the bisection inverse of the linearity (kernel D, S and exflag; and
``make_l1_fullcal`` under either ``lin_backend``), the slab IPC inverse
behind its four entry points (against the twin and against each other),
the frame IPC inverse (the same kernel in the Neumann order; signed
zeros and NaN positions too) and the L1 -> L2 product are held bit for
bit.  The
pixel-area map made on the card (float64) against the CPU's: within the
benchmark's ``area_gap`` limit.  The pink transform (the wgmma path and, below length 2^16, the mma.sync
path) shares its twin's cast points and sums in another order:
difference std < 1e-2 and max < 5e-2 of the frame std (the JAX
package's gate for its two paths).  The sim with kernels against the
plain sim, one seed: within 1 DN on every pixel (the pink frames differ
in their last bits before the rounding to integer DN).  The plain path
on the card against the plain path on the CPU: the slice's parity gates
(``utils/parity.py``).
"""

import gc
import json
import sys
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import map_cases
import numpy as np
import pytest
import torch

from romanimpreprocess_tpu_torch import synth
from romanimpreprocess_tpu_torch.dqflags import i32, pixel
from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles, fits_lite, staging
from romanimpreprocess_tpu_torch import benchlib
from romanimpreprocess_tpu_torch.ops import (contract_cuda, invlin_cuda, ipc,
                                             ipc_cuda, ipc_slab, linearity,
                                             linearity_cuda, median_cuda, pink,
                                             pink_cuda, rand, sky, wcsutils)
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, noise, sim_to_l1
from romanimpreprocess_tpu_torch.utils import parity, profiling, time_frame
from romanimpreprocess_tpu_torch.utils.rows import Rows

torch.set_num_threads(1)

CUDA_REASON = "needs CUDA; verified by chip_smoke.py on the H100"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(CUDA_REASON)
    return torch.device("cuda")


def _same(a, b):
    return bool(((a == b) | (np.isnan(a) & np.isnan(b))).all())


# (ngrp, nside, nborder): groups 1, 6, 9 and 17 (one and two register
# chunks) at nside 20 (narrower than one warp strip), 67, 131 and 1000
# with nborder 4; nborder 2, 0, 1 and 3 once each
FRAME_CASES = ([(g, n, 4) for g in (1, 6, 9, 17) for n in (20, 67, 131, 1000)]
               + [(6, 131, 2), (3, 67, 0), (2, 67, 1), (9, 130, 3)])


@pytest.mark.cuda
@pytest.mark.parametrize("ngrp,nside,nb", FRAME_CASES)
def test_ipc_frame_cuda_matches_plain(cuda_device, ngrp, nside, nb):
    """The frame inverse (the slab kernel in the Neumann order) against
    its twin, bit for bit (signed zeros alike, NaN at the same places):
    on negative data, and again with a NaN and infinities in the two
    border rows and columns next to the active region (inside it for
    nborder 0), which reach the output through their zero weights in
    both (``time_frame.inputs``).  One launch each; border passed
    through."""
    gen = torch.Generator(device=cuda_device).manual_seed(nside + ngrp + nb)
    border = torch.ones((nside, nside), dtype=torch.bool, device=cuda_device)
    border[nb : nside - nb, nb : nside - nb] = False
    for nonfinite in (False, True):
        x, planes, g = time_frame.inputs(ngrp, nside, nb, gen, nonfinite)
        n0 = ipc_cuda.launches
        got = ipc_cuda.ipc_rev2_frame(x, planes, g, nb)
        ref = ipc_cuda.ipc_rev2_frame_plain(x, planes, g, nb)
        torch.cuda.synchronize()
        assert ipc_cuda.launches == n0 + 1
        assert time_frame.same_bits(got[:, border], x[:, border])
        assert time_frame.same_bits(got, ref)
        assert bool(torch.isfinite(got).all()) != nonfinite


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx", [(64, 96), (20, 130)])
def test_linearity_cuda_matches_plain(cuda_device, ny, nx):
    rng = np.random.RandomState(7)
    ngrp = 5
    coefs = (rng.randn(4, ny, nx) * 0.1 + np.array([0, 3e4, 0, 0])[:, None, None])
    smin = rng.rand(ny, nx) * 100
    dq = (np.where(rng.rand(ny, nx) < 0.05, pixel.NO_LIN_CORR, 0)
          | np.where(rng.rand(ny, nx) < 0.05, pixel.REFERENCE_PIXEL, 0)).astype(np.uint32)
    S = smin[None] + rng.rand(ngrp, ny, nx) * 5e4 - 2000
    att = rng.rand(ngrp, ny, nx) < 0.9
    # pixel (0, 0): clean, in range until group 2 extrapolates, so groups
    # 3.. must fall back (the sequential DQ feedback)
    dq[0, 0] = 0
    att[:, 0, 0] = True
    S[:, 0, 0] = smin[0, 0] + np.array([1e4, 2e4, 4.5e4, 3e4, 3e4])

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda_device)

    lin = linearity.LinearityData(
        dev(coefs), dev(smin), dev(smin + 40000), dev(smin + 200),
        torch.from_numpy(dq.view(np.int32)).to(cuda_device))
    St, at = dev(S), torch.from_numpy(att).to(cuda_device)
    for dnff in (True, False):
        n0 = linearity_cuda.launches
        got, dq_got = linearity_cuda.apply_linearity_cube_fused(St, lin, at, dnff)
        ref, dq_ref = linearity.apply_linearity_cube(St, lin, dnff, at)
        torch.cuda.synchronize()
        assert linearity_cuda.launches == n0 + 1
        assert torch.equal(dq_got, dq_ref)
        assert torch.equal(got, ref)
        assert (dq_got[0, 0] & i32(pixel.NO_LIN_CORR)).item() != 0


def _nanmedian_oracle(arr, N):
    ky, kx, py, px = sky.block_geometry(*arr.shape, N)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.nanmedian(arr[py : py + N * ky, px : px + N * kx]
                            .reshape(N, ky, N, kx), axis=(1, 3))


# (ny, nx, N, the size branch it must take, noise or edge values)
MEDIAN_CASES = [
    (130, 125, 8, ("cluster", 1), "noise"), (128, 120, 4, ("cluster", 1), "edges"),
    (803, 1001, 4, ("cluster", 2), "edges"), (301, 260, 1, ("cluster", 4), "noise"),
    (1022, 1022, 2, ("cluster", 8), "edges"), (1022, 1022, 2, ("cluster", 8), "sky"),
    (640, 640, 1, ("cluster", 8), "noise"), (400, 400, 128, ("cluster", 1), "noise"),
    (700, 701, 1, ("stream", 0), "noise"), (1300, 1310, 2, ("stream", 0), "edges"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,N,path,kind", MEDIAN_CASES)
def test_block_nanmedian_cuda_bit_identical(cuda_device, ny, nx, N, path, kind):
    """Every size branch against the twin and np.nanmedian, bit for bit,
    on a contiguous tensor and on a row-strided view.  ``edges``: values
    from (-inf, -1, -0.0, +0.0, 1, +inf), so every median lies among
    duplicates, signed zeros or infinities, with even and odd counts.
    ``sky``: a nearly constant frame (all keys share their top digits)."""
    assert median_cuda.plan(ny, nx, N)[:2] == path
    rng = np.random.RandomState(ny + N)
    if kind == "edges":
        vals = np.array([-np.inf, -1.0, -0.0, 0.0, 1.0, np.inf], np.float32)
        arr = vals[rng.randint(0, 6, (ny, nx))]
    elif kind == "sky":
        arr = (1000.0 + rng.randn(ny, nx)).astype(np.float32)
    else:
        arr = (rng.randn(ny, nx) * 100).astype(np.float32)
    arr[rng.rand(ny, nx) < 0.2] = np.nan
    ky, kx, py, px = sky.block_geometry(ny, nx, N)
    arr[py : py + ky, px : px + kx] = np.nan  # one all-NaN block
    if N > 1:  # a block with one valid value
        arr[py : py + ky, px + kx : px + 2 * kx] = np.nan
        arr[py + ky // 2, px + kx + kx // 2] = -0.0
    a = torch.from_numpy(arr).to(cuda_device)
    frame = torch.zeros((ny + 8, nx + 8), device=cuda_device)
    frame[4:-4, 4:-4] = a
    oracle = _nanmedian_oracle(arr, N)
    for view in (a, frame[4:-4, 4:-4]):  # contiguous and row-strided
        n0 = median_cuda.launches
        got = median_cuda.block_nanmedian_fused(view, N).cpu().numpy()
        ref = sky.block_nanmedian(view, N).cpu().numpy()
        assert median_cuda.launches == n0 + 1
        assert _same(got, ref)
        assert _same(got, oracle)
        assert np.isnan(got[0, 0])
        if N > 1:
            assert got[0, 1] == 0.0
        again = median_cuda.block_nanmedian_fused(view, N).cpu().numpy()
        assert _same(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("values", [
    [3.0, 1.0, 2.0], [1.0, 2.0, 3.0, 4.0], [5.0, 1.0, 2.0, 2.0, 2.0, 2.0, 9.0, 0.5],
    [1.0, 2.0, 2.0, 7.0], [-0.0, 0.0, -0.0, 0.0], [-1.0, -0.0, 0.0, 1.0],
    [-np.inf, -np.inf, np.inf, np.inf], [-np.inf, 1.0, 2.0, np.inf], [np.inf] * 5,
    [np.nan, -0.0, np.nan, np.nan], [np.nan, 4.0, np.nan, -4.5], [np.nan] * 6,
    [1e-45, -1e-45, 3e-45, 0.0], [3.4e38, -3.4e38, 1e-38, -1e-38, 0.0]])
def test_block_nanmedian_cuda_edge_blocks(cuda_device, values):
    blk = np.array(values, np.float32)[None]
    got = median_cuda.block_nanmedian_fused(torch.from_numpy(blk).to(cuda_device), 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.nanmedian(blk)
    assert _same(got.cpu().numpy()[0, 0], np.float32(want))


@pytest.mark.cuda
def test_calibrateimage_kernels_match_plain_path(cuda_device, tmp_path):
    d = str(tmp_path)
    rp = synth.READ_PATTERN_DEFAULT
    caldir = synth.make_cal_files(d + "/cal", rp, nside=64, seed=5)
    cal = synth.synth_cal_arrays(64, rp, seed=5)
    data = synth.synth_l1_cube(cal, rp, rate_dn_s=10.0, nborder=4)
    synth.write_l1_file(d + "/L1.asdf", data, rp,
                        amp33=synth.synth_amp33(64, len(rp), 4))
    base = {"IN": d + "/L1.asdf", "CALDIR": caldir, "SKYORDER": 2, "SLICEOUT": True}
    mods = (ipc_cuda, linearity_cuda, median_cuda)
    n0 = [m.launches for m in mods]
    l1_to_l2.calibrateimage(dict(base, OUT=d + "/k.asdf"), device=cuda_device)
    assert [m.launches for m in mods] == [n + 1 for n in n0]
    plain = {k: "xla" for k in ("IPC_BACKEND", "LIN_BACKEND", "SKY_BACKEND")}
    l1_to_l2.calibrateimage(dict(base, OUT=d + "/p.asdf", **plain), device=cuda_device)
    got, ref = asdf_lite.open(d + "/k.asdf"), asdf_lite.open(d + "/p.asdf")
    for k in ("data", "data_withsky", "dq", "err", "var_poisson", "var_rnoise"):
        np.testing.assert_array_equal(np.asarray(got["roman"][k]),
                                      np.asarray(ref["roman"][k]), err_msg=k)
    for k in ("skycoefs", "endslice"):
        np.testing.assert_array_equal(np.asarray(got["processinfo"][k]),
                                      np.asarray(ref["processinfo"][k]), err_msg=k)


@pytest.mark.cuda
def test_area_map_on_cuda_matches_cpu_at_4096(cuda_device, tmp_path):
    """``calibrateimage``'s pixel-area map (``area_factor_from_config``,
    float64 arithmetic) made on the card at 4096^2 against the CPU's,
    within the benchmark's ``area_gap`` limit
    (``gpubench/limits/l2_classic_wcsarea.json``), counted ``area_device``,
    with no host copy."""
    limits = Path(__file__).resolve().parents[1] / "gpubench/limits/l2_classic_wcsarea.json"
    limit = json.loads(limits.read_text())["area_gap"]
    n, s, roll = 4096, 0.11 / 3600.0, np.radians(57.0)
    rng = np.random.default_rng(23)
    sip = {(p, q): float(rng.normal(0.0, 2e-7 if p + q == 2 else 5e-11))
           for p in range(4) for q in range(4 - p) if p + q >= 2}
    cd = [[-s * np.cos(roll), s * np.sin(roll)], [s * np.sin(roll), s * np.cos(roll)]]
    w = wcsutils.SIPWCS([2043.5, 2043.5], cd, [61.3, -37.9], a_coefs=sip,
                        b_coefs={k: -0.7 * v for k, v in sip.items()})
    hdr = fits_lite.Header()
    for k, v in w.to_cards().items():
        hdr[k] = v
    hdr.tofile(str(tmp_path / "L1_asdf_wcshead.txt"), overwrite=True)
    config = {"FITSWCS": str(tmp_path / "L1_asdf_wcshead.txt")}
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = l1_to_l2.area_factor_from_config(config, n, device=cuda_device)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters.get("area_device") == 1 and "area_host" not in counters
    assert "d2h_bytes" not in counters and "h2d_bytes" not in counters
    assert got.device.type == "cuda" and got.dtype == torch.float32 and got.shape == (n, n)
    want = l1_to_l2.area_factor_from_config(config, n, device="cpu").to(torch.float64)
    gap = float(((got.cpu().double() - want).abs() / want).max())
    assert gap <= limit, gap


@pytest.mark.cuda
@pytest.mark.parametrize("ngrp,nreads,ny,nx", [(6, 14, 120, 120), (11, 5, 37, 53)])
def test_contract_cuda_bit_identical(cuda_device, ngrp, nreads, ny, nx):
    rng = np.random.RandomState(ngrp)
    T = torch.from_numpy(rng.normal(size=(ngrp, nreads)).astype(np.float32)).to(cuda_device)
    x = torch.from_numpy(rng.poisson(20.0, (nreads, ny, nx)).astype(np.float32)).to(cuda_device)
    n0 = contract_cuda.launches
    got = contract_cuda.contract_reads(T, x)
    ref = contract_cuda.contract_reads_plain(T, x)
    torch.cuda.synchronize()
    assert contract_cuda.launches == n0 + 1
    assert torch.equal(got, ref)
    lib = torch.einsum("jr,ryx->jyx", T, x)
    assert (got - lib).abs().max() <= 1e-5 * lib.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("ngrp,na", [(6, 120), (3, 67)])
def test_ipc_fwd_cuda_bit_identical(cuda_device, ngrp, na):
    rng = np.random.RandomState(na)
    K = rng.uniform(0, 0.02, (3, 3, na, na)).astype(np.float32)
    K[1, 1] = 1 - K.sum(axis=(0, 1)) + K[1, 1]
    K = torch.from_numpy(K).to(cuda_device)
    cube = torch.from_numpy(rng.uniform(0, 5e4, (ngrp, na, na)).astype(np.float32)).to(cuda_device)
    gain = torch.from_numpy(rng.uniform(1.4, 1.6, (na, na)).astype(np.float32)).to(cuda_device)
    for g in (None, gain):
        n0 = ipc_cuda.fwd_launches
        got = ipc_cuda.ipc_fwd_cube(cube, K, g)
        ref = ipc.ipc_fwd(cube, K, g)
        torch.cuda.synchronize()
        assert ipc_cuda.fwd_launches == n0 + 1
        assert torch.equal(got, ref)


def _invlin_case(nside, ncoef, dev, seed=0):
    """(gain, lin) full frames: ``synth``'s order-3 expansion cut, or
    extended by small higher orders (a few DN at the ends of the range)."""
    cal = synth.synth_cal_arrays(nside, synth.READ_PATTERN_DEFAULT, seed=seed)
    rng = np.random.RandomState(seed)
    extra = rng.uniform(-5.0, 5.0, (max(ncoef - 4, 0), nside, nside))
    coefs = np.concatenate([cal["lin_coefs"], extra.astype(np.float32)])[:ncoef]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    lin = linearity.LinearityData(
        t(coefs), t(cal["lin_smin"]), t(cal["lin_smax"]), t(cal["lin_sref"]),
        torch.from_numpy(cal["lin_dq"].view(np.int32)).to(dev))
    return t(cal["gain"]), lin


@pytest.mark.cuda
@pytest.mark.parametrize("ngrp,nside,nb,ncoef", [
    (8, 512, 0, 7),      # the lane's groups and order
    (8, 520, 4, 7),      # the same in a border's window
    (None, 256, 0, 7),   # one 2-D frame (ngrp 1)
    (None, 256, 0, 4),   # four coefficients
    (3, 130, 4, 4)])
def test_invlin_cuda_bit_identical(cuda_device, ngrp, nside, nb, ncoef):
    """Kernel D against ``(x / gain)`` -> ``linearity.invert_linearity``
    on the active window, S and exflag bit for bit; x from below the
    range to above it, so that z reaches both domain edges."""
    gain, lin = _invlin_case(nside, ncoef, cuda_device)
    na = nside - 2 * nb
    act = slice(nb, nside - nb)
    shape = (na, na) if ngrp is None else (ngrp, na, na)
    rng = np.random.RandomState(nside + ncoef)
    slin = torch.from_numpy(rng.uniform(-3000, 70000, shape).astype(np.float32))
    x = (slin.to(cuda_device) * gain[act, act]).contiguous()
    lin_act = linearity.LinearityData(*(a[..., act, act] for a in lin))
    n0 = invlin_cuda.launches
    got, ex_got = invlin_cuda.invert_linearity_fused(x, gain, lin)
    want, ex_want = linearity.invert_linearity(x / gain[act, act], lin_act)
    torch.cuda.synchronize()
    assert invlin_cuda.launches == n0 + 1
    assert got.shape == x.shape and ex_got.dtype == torch.bool
    assert torch.equal(got, want)
    assert torch.equal(ex_got, ex_want)
    z = (got - lin_act.smin) / (lin_act.smax - lin_act.smin) * 2 - 1
    assert float(z.min()) < -1 + 1e-5 and float(z.max()) > 1 - 1e-5


@pytest.mark.cuda
def test_make_l1_fullcal_lin_backends_bit_identical(cuda_device):
    """``make_l1_fullcal`` at one seed under ``lin_backend`` 'cuda' and
    'xla': resultants and DQ bit for bit, one launch of kernel D a call
    under 'cuda' and none under 'xla'."""
    _arr, _prep, pack = benchlib.exposure_bundle(nside=256, device=cuda_device)
    rate = torch.from_numpy(np.random.RandomState(3).uniform(
        0, 3000, (248, 248)).astype(np.float32)).to(cuda_device)
    out = {}
    for b in ("cuda", "xla"):
        n0 = invlin_cuda.launches
        out[b] = sim_to_l1.make_l1_fullcal(
            rand.sim_generator(11, cuda_device), rate, synth.READ_PATTERN_DEFAULT,
            pack, crparam={}, ipc_backend="cuda", lin_backend=b)
        torch.cuda.synchronize()
        assert invlin_cuda.launches == n0 + (b == "cuda")
    assert torch.equal(out["cuda"][0], out["xla"][0])
    assert torch.equal(out["cuda"][1], out["xla"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("ngrp,na,th,with_gain,padded", [
    (3, 96, 16, True, True), (1, 100, 8, False, False), (2, 100, 16, True, False),
    (2, 131, 32, False, True),
    # group counts above one register chunk, a frame narrower than one
    # warp strip, sizes that are multiples of neither strip nor segment
    (9, 67, 32, True, True), (17, 131, 8, False, False), (2, 20, 8, True, False),
    (6, 1000, 32, True, True), (9, 1000, 16, False, True)])
def test_ipc_slab_cuda_bit_identical(cuda_device, ngrp, na, th, with_gain, padded):
    """The slab kernel behind its four entry points (cube: blocked,
    streaming; frame: fused, streaming route) against the twin, bit for
    bit; one launch counted per call, on the entry's own counter."""
    rng = np.random.RandomState(na + ngrp)
    nb, nside = 4, na + 8
    K = rng.uniform(0, 0.02, (3, 3, na, na)).astype(np.float32)
    K[1, 1] = 1 - K.sum(axis=(0, 1)) + K[1, 1]
    kern = ipc_slab.kernel_planes_padded(K, th=th) if padded else K
    kern = torch.from_numpy(kern).to(cuda_device)
    data = torch.from_numpy(rng.uniform(0, 1000, (ngrp, nside, nside))
                            .astype(np.float32)).to(cuda_device)
    gain = torch.from_numpy(rng.uniform(1.4, 1.6, (nside, nside))
                            .astype(np.float32)).to(cuda_device)
    # a row-pitched view of the full-frame gain, as the core passes it
    g = gain[nb:-nb, nb:-nb] if with_gain else None
    cube = data[:, nb:-nb, nb:-nb].contiguous()
    n0 = (ipc_slab.blocked_launches, ipc_slab.stream_launches, ipc_slab.fused_launches)
    blocked = ipc_slab.ipc_rev2_cube_blocked(cube, kern, g, th=th)
    stream = ipc_slab.ipc_rev2_cube_stream(cube, kern, g, th=th)
    fused = ipc_slab.correct_cube_fused(data, kern, g, nborder=nb, th=th)
    sframe = ipc_slab.correct_cube_stream(data, kern, g, nborder=nb, th=th)
    torch.cuda.synchronize()
    assert (ipc_slab.blocked_launches, ipc_slab.stream_launches,
            ipc_slab.fused_launches) == (n0[0] + 2, n0[1] + 2, n0[2] + 1)
    ref = ipc_slab.ipc_rev2_plain(
        cube, torch.from_numpy(K).to(cuda_device).reshape(9, na, na), g)
    assert torch.equal(blocked, ref) and torch.equal(stream, ref)
    frame = ipc_slab.correct_cube_plain(data, kern, g, nborder=nb, th=th)
    assert torch.equal(fused, frame) and torch.equal(sframe, frame)
    assert torch.equal(fused[:, nb:-nb, nb:-nb], blocked)
    assert torch.equal(fused[:, :nb], data[:, :nb])
    assert torch.equal(fused[:, :, -nb:], data[:, :, -nb:])
    with pytest.raises(ValueError, match="contiguous"):
        ipc_slab.ipc_rev2_cube_blocked(data[:, nb:-nb, nb:-nb], kern, g, th=th)
    with pytest.raises(ValueError, match="contiguous"):
        ipc_slab.correct_cube_stream(data.transpose(1, 2), kern, g, nborder=nb, th=th)
    if padded:
        with pytest.raises(ValueError, match="slab geometry"):
            ipc_slab.ipc_rev2_cube_stream(cube, kern, g, th=2 * th)


@pytest.mark.cuda
def test_calibrateimage_likelihood_slab_routes_match(cuda_device, tmp_path):
    d = str(tmp_path)
    rp = synth.READ_PATTERN_DEFAULT
    caldir = synth.make_cal_files(d + "/cal", rp, nside=64, seed=5)
    cal = synth.synth_cal_arrays(64, rp, seed=5)
    data = synth.synth_l1_cube(cal, rp, rate_dn_s=10.0, nborder=4)
    synth.write_l1_file(d + "/L1.asdf", data, rp,
                        amp33=synth.synth_amp33(64, len(rp), 4))
    base = {"IN": d + "/L1.asdf", "CALDIR": caldir, "SKYORDER": 2, "SLICEOUT": True,
            "romancal_ramp_fit": True}
    counts = lambda: (ipc_cuda.launches, ipc_slab.blocked_launches,
                      ipc_slab.fused_launches, ipc_slab.stream_launches)
    n0 = counts()
    a = l1_to_l2.calibrateimage(dict(base, OUT=d + "/a.asdf", IPC_BACKEND="pallas"),
                                device=cuda_device, return_arrays=True)
    assert counts() == (n0[0], n0[1] + 1, n0[2] + 1, n0[3])
    b = l1_to_l2.calibrateimage(dict(base, OUT=d + "/b.asdf", IPC_BACKEND="pallas-stream"),
                                device=cuda_device, return_arrays=True)
    assert counts() == (n0[0], n0[1] + 1, n0[2] + 1, n0[3] + 1)
    assert set(a) == set(l1_to_l2.PRODUCT_OUTPUTS) | {"dumo", "chisq"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the slab twin through the same core, LIN / SKY plain
    l1 = asdf_lite.open(d + "/L1.asdf")["roman"]
    from romanimpreprocess_tpu_torch.io import calfiles
    pack = calfiles.load_caldir_cached(caldir)
    prep = l1_to_l2.prepare_inputs(
        l1, dict(base, IPC_BACKEND="pallas", LIN_BACKEND="xla", SKY_BACKEND="xla"),
        pack, device=cuda_device)
    prep["cfg"]["ipc"] = "slab-plain"
    p = staging.to_host(l1_to_l2.make_core(prep["plan"], prep["cfg"],
                                           prep["geom"])(prep["arr"]))
    assert counts() == (n0[0], n0[1] + 1, n0[2] + 1, n0[3] + 1)
    for k in a:
        np.testing.assert_array_equal(a[k], p[k], err_msg=k)
    im = asdf_lite.open(d + "/a.asdf")["roman"]
    assert im["dumo"].dtype == np.float16 and im["chisq"].dtype == np.float16


@pytest.mark.cuda
def test_plain_path_on_cuda_matches_cpu(cuda_device, tmp_path):
    """The port's plain path (every backend ``xla`` / ``dot``) on the card
    against the same path on the CPU, 128^2 (``parity.plain_devices``):
    on the card other library kernels run (batched matrix products,
    ``torch.linalg.solve``, reductions).  The classic fit through
    ``calibrateimage`` and the likelihood fit through the core with the
    slab route's twin at the slice's gates; the example noise layers at
    the spread gates (the two RNG streams differ); the sim at its moment gates
    (8 seeds) and its envelope gates through sim -> L1 -> L2 on each
    device (the two RNG streams differ)."""
    rep = parity.plain_devices(str(tmp_path), "cpu", cuda_device)
    assert set(rep) == {"classic", "likely_slab_plain", "noise", "sim_moments",
                        "sim_envelope_cpu", "sim_envelope_cuda", "bits"}
    assert set(rep["bits"]) == {"classic", "likely_slab_plain"}
    assert len(rep["noise"]) == len(parity.NOISE_LAYERS)
    assert rep["classic"]["jump_det_diff_frac"] <= 1e-4
    assert rep["sim_moments"]["mean_dev_sigma"] < 4


# (transforms, length, wgmma path): 2^14 and 2^15 take the mma.sync
# kernels, longer lengths the wgmma ones; 2^15 and 2^17 have n1 != n2
PINK_CASES = [(1, 1 << 14, False), (3, 1 << 14, False), (2, 1 << 15, False),
              (1, 1 << 16, True), (3, 1 << 16, True), (2, 1 << 17, True),
              (5, 1 << 17, True), (1, 1 << 20, True), (3, 1 << 20, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("ntr,length,wgmma", PINK_CASES)
def test_pink_cuda_matches_plain(cuda_device, ntr, length, wgmma):
    assert pink_cuda.uses_wgmma(*pink.split_length(length)) == wgmma
    gen = torch.Generator(device=cuda_device).manual_seed(length)
    white = torch.randn((ntr, 2, length), generator=gen, device=cuda_device,
                        dtype=torch.bfloat16)
    n0 = pink_cuda.launches
    got = pink_cuda.pink_from_white(white)
    torch.cuda.synchronize()
    assert pink_cuda.launches == n0 + 1
    ref = pink.pink_from_white_plain(white)
    assert got.shape == ref.shape == (2 * ntr, length // 2)
    s = ref.std()
    d = (got - ref).abs()
    assert d.std() < 1e-2 * s and d.max() < 5e-2 * s
    assert got.mean(dim=-1).abs().max() < 1e-3 * s
    assert torch.equal(pink_cuda.pink_from_white(white), got)  # no atomics
    with pytest.raises(ValueError, match="multiples of 128"):
        pink_cuda.pink_from_white(white[:, :, : 1 << 12].contiguous())


@pytest.mark.cuda
def test_run_config_kernels_match_plain_path(cuda_device, tmp_path):
    d = str(tmp_path)
    rp = synth.READ_PATTERN_DEFAULT
    reads = [v for g in rp for v in (g[0], g[-1] + 1)]
    # 256^2 with two 128-wide channels: the smallest frame whose pink
    # length (2 * 256 * 128 = 2^16) takes the kernel's branch
    scene = synth.make_scene_file(d + "/truth_F184_163_4.fits", nside_active=248,
                                  nstars=3)
    caldir = synth.make_cal_files(d + "/cal", rp, nside=256, seed=5, channelwidth=128)
    base = {"IN": scene, "READS": reads, "CALDIR": caldir, "SEED": 7}
    counts = lambda: (contract_cuda.launches, ipc_cuda.fwd_launches, pink_cuda.launches,
                      invlin_cuda.launches)
    n0 = counts()
    sim_to_l1.run_config(dict(base, OUT=d + "/k.asdf", CONTRACT_BACKEND="pallas"),
                         device=cuda_device)
    assert counts() == tuple(n + 1 for n in n0)
    sim_to_l1.run_config(dict(base, OUT=d + "/p.asdf", IPC_BACKEND="xla",
                              LIN_BACKEND="xla", PINK_BACKEND="xla",
                              CONTRACT_BACKEND="dot"),
                         device=cuda_device)
    assert counts() == tuple(n + 1 for n in n0)
    got, ref = asdf_lite.open(d + "/k.asdf")["roman"], asdf_lite.open(d + "/p.asdf")["roman"]
    np.testing.assert_array_equal(got["resultantdq"], ref["resultantdq"])
    for k in ("data", "amp33"):
        diff = np.abs(got[k].astype(np.int32) - ref[k].astype(np.int32))
        assert diff.max() <= 1, k
        assert (diff == 0).mean() >= 0.9, k


@pytest.mark.cuda
def test_noise_cube_device_strict_reaches_kernels(cuda_device, tmp_path):
    """``make_noise_cube`` with ``device-strict`` on the card: the example
    layers launch the pink transform (each 'R' fill), the read
    contraction ('P...r' under ``CONTRACT_BACKEND: pallas``) and the block
    median ('S', 'Pb'), besides the core's kernels; the cube is finite,
    the same seed gives the same cube, and the plain path's cube (every
    backend ``xla`` / ``dot``) meets the spread gates.  256^2 with two
    128-wide channels: the smallest frame whose pink length takes the
    kernel's branch."""
    d = str(tmp_path)
    rp = synth.READ_PATTERN_DEFAULT
    caldir = synth.make_cal_files(d + "/cal", rp, nside=256, seed=5, channelwidth=128)
    cal = synth.synth_cal_arrays(256, rp, seed=5, channelwidth=128)
    synth.write_l1_file(d + "/L1.asdf",
                        synth.synth_l1_cube(cal, rp, rate_dn_s=10.0, nborder=4), rp,
                        amp33=synth.synth_amp33(256, len(rp), 128))
    cfg = {"IN": d + "/L1.asdf", "OUT": d + "/L2.asdf", "CALDIR": caldir,
           "SKYORDER": 2, "SLICEOUT": True, "CONTRACT_BACKEND": "pallas",
           "NOISE": {"LAYER": list(parity.NOISE_LAYERS), "SEED": 15000,
                     "BACKEND": "device-strict"}}
    l1_to_l2.calibrateimage(cfg, device=cuda_device)
    mods = (pink_cuda, contract_cuda, median_cuda, linearity_cuda, ipc_cuda)
    n0 = [m.launches for m in mods]
    cube = noise.make_noise_cube(cfg, device=cuda_device)
    assert all(m.launches > n for m, n in zip(mods, n0)), [m.launches for m in mods]
    assert cube.shape == (2, 248, 248) and np.isfinite(cube).all()
    np.testing.assert_array_equal(noise.make_noise_cube(cfg, device=cuda_device), cube)
    plain = dict(cfg, IPC_BACKEND="xla", LIN_BACKEND="xla", SKY_BACKEND="xla",
                 PINK_BACKEND="xla", CONTRACT_BACKEND="dot")
    n1 = [m.launches for m in mods]
    ref = noise.make_noise_cube(plain, device=cuda_device)
    assert [m.launches for m in mods] == n1
    good = np.asarray(asdf_lite.open(cfg["OUT"])["roman"]["dq"]) == 0
    parity.compare_noise(ref, cube, good, "noise, kernels vs plain, 256^2")


# --------------------------------------------------------------------------
# the focal-plane layer on the card
# --------------------------------------------------------------------------

def _fpa_inputs(d, scas, nside=128):
    """Per SCA a port CALDIR (its own seed) and synthetic L1 at ``nside``^2:
    the ``calibrateimage`` configs."""
    rp = synth.READ_PATTERN_DEFAULT
    configs = []
    for sca in scas:
        caldir = synth.make_cal_files(d + f"/cal{sca}", rp, nside=nside, seed=sca, sca=sca)
        cal = synth.synth_cal_arrays(nside, rp, seed=sca)
        synth.write_l1_file(d + f"/L1_{sca}.asdf",
                            synth.synth_l1_cube(cal, rp, seed=sca, rate_dn_s=10.0,
                                                nborder=4), rp,
                            amp33=synth.synth_amp33(nside, len(rp), max(nside // 32, 4)))
        configs.append({"IN": d + f"/L1_{sca}.asdf", "OUT": d + f"/L2fpa_{sca}.asdf",
                        "CALDIR": caldir, "SKYORDER": 2, "SLICEOUT": True})
    return configs


@pytest.mark.cuda
def test_calibrate_fpa_is_calibrateimage_on_cuda(cuda_device, tmp_path):
    from romanimpreprocess_tpu_torch import parallel

    d = str(tmp_path)
    configs = _fpa_inputs(d, (4, 5, 7))
    n0 = linearity_cuda.launches
    trees, timings = parallel.calibrate_fpa(configs, mesh=parallel.sca_mesh(), profile=True)
    assert linearity_cuda.launches == n0 + 3
    assert timings["peak_mem_gb"] > 0 and sum(g["n_sca"] for g in timings["groups"]) == 3
    for c, tree in zip(configs, trees):
        cs = dict(c, OUT=c["OUT"][:-5] + "_single.asdf")
        l1_to_l2.calibrateimage(cs, device=cuda_device)
        parity.same_tree(asdf_lite.open(c["OUT"]).tree, asdf_lite.open(cs["OUT"]).tree,
                         c["IN"], subst=(c["OUT"], cs["OUT"]))


@pytest.mark.cuda
def test_exposure_runner_lanes_are_single_runs_on_cuda(cuda_device):
    from romanimpreprocess_tpu_torch import benchlib, parallel
    from romanimpreprocess_tpu_torch.pipeline import noise_core

    arr, prep, pack = benchlib.exposure_bundle(nside=256, device=cuda_device,
                                               config={"CONTRACT_BACKEND": "pallas"})
    layers = list(parity.NOISE_LAYERS)
    mesh = parallel.sca_mesh()
    run_b = parallel.make_fpa_exposure_runner(prep, pack, layers, mesh,
                                              config={"CONTRACT_BACKEND": "pallas"})
    counts = lambda: (linearity_cuda.launches, contract_cuda.launches)
    n0 = counts()
    cube, base, checks = run_b(11, parallel.broadcast_batch(arr, 3))
    n1 = counts()
    run_1 = noise_core.make_staged_exposure_runner(prep, pack, layers,
                                                   config={"CONTRACT_BACKEND": "pallas"})
    for i in range(3):
        c1, b1, k1 = run_1(noise.lane_seed(11, i), arr)
        if i == 0:  # three lanes launch what three single runs launch
            one = [b - a for a, b in zip(n1, counts())]
            assert one[0] >= 4 and one[1] >= 1
            assert [b - a for a, b in zip(n0, n1)] == [3 * k for k in one]
        assert torch.equal(cube[i], c1) and torch.equal(checks[i], k1), i
        assert torch.equal(base["pdq"][i], b1["pdq"]), i
    assert not torch.equal(cube[0], cube[1])


@pytest.mark.cuda
def test_process_exposure_fpa_files_equal_serial_on_cuda(cuda_device, tmp_path):
    import os

    from romanimpreprocess_tpu_torch.pipeline import batch

    d = str(tmp_path)
    rp = synth.READ_PATTERN_DEFAULT
    os.makedirs(d + "/IN")
    os.makedirs(d + "/CAL")
    for sca in (4, 5):
        synth.make_scene_file(d + f"/IN/Roman_Test_truth_F184_163_{sca}.fits",
                              nside_active=120, nstars=3)
        synth.make_cal_files(d + "/CAL/roman_wfi", rp, nside=128, seed=5, tag="T", sca=sca)
    reads = ",".join(str(v) for g in rp for v in (g[0], g[-1] + 1))
    args = [f"--in={d}/IN", f"--cal={d}/CAL", "--tag=T", "--sca=all", f"--reads={reads}",
            "--layers=Rz4PbrS2C1,Rz4OS2C2"]
    batch.run(args + [f"--out={d}/S"])
    batch.run(args + [f"--out={d}/F", "--fpa"])
    for sca in (4, 5):
        for rel in (f"L1/sim_L1_F184_163_{sca}.asdf", f"L2/sim_L2_F184_163_{sca}.asdf",
                    f"L2/sim_L2_F184_163_{sca}_noise.asdf"):
            parity.same_tree(asdf_lite.open(f"{d}/S/{rel}").tree,
                             asdf_lite.open(f"{d}/F/{rel}").tree, rel,
                             subst=(f"{d}/S", f"{d}/F"))
        rel = f"L2/sim_L2_F184_163_{sca}_mask.fits"
        with open(f"{d}/S/{rel}", "rb") as f, open(f"{d}/F/{rel}", "rb") as g:
            assert f.read() == g.read()


# ---- calib on the card against the CPU (128^2) ----

def _toy_ramps(n=128, seed=42):
    """Two flat ramps (15 and 20 frames at 3.04 s) through the toy curve
    of ``tests/test_characterize.py``, by the port's inverse linearity
    on the CPU, and the bias frame."""
    rng = np.random.RandomState(seed)
    smin = np.full((n, n), 4000.0, np.float32)
    smax = (56000 + 2000 * rng.uniform(size=(n, n))).astype(np.float32)
    sref = (smin + 1000).astype(np.float32)
    data = np.zeros((4, n, n), np.float32)
    data[2] = 100 + 80 * rng.uniform(size=(n, n))
    z = 2 * (sref - smin) / (smax - smin) - 1
    data[1] = (smax - smin) / 2.0 - 3 * data[2] * z
    data[0] = -data[1] * z - data[2] * (1.5 * z**2 - 0.5)
    lin = linearity.LinearityData(*(torch.from_numpy(a) for a in (data, smin, smax, sref)),
                                  torch.zeros((n, n), dtype=torch.int32))
    ts = [np.arange(1, 16) * 3.04, np.arange(1, 21) * 3.04]
    ramps = [torch.stack([linearity.invert_linearity(
        torch.full((n, n), a * t, dtype=torch.float32), lin)[0] for t in tt]).numpy()
        for a, tt in zip((900.0, 200.0), ts)]
    bias = linearity.invert_linearity(torch.zeros((n, n)), lin)[0].numpy()
    return lin, ramps, ts, bias


@pytest.mark.cuda
def test_calib_fit_linearity_on_cuda_matches_cpu(cuda_device, monkeypatch):
    """The linearity fit (the card's batched solve, the CPU's LAPACK):
    the domain planes and the dq equal, the linearised signal at the
    four fractions within 1e-4 relative (median) and 1e-3 (largest), the
    tolerance held against the JAX package on the CPU.  Without
    ``device`` the fit runs on ``cuda`` (here over four row slabs)."""
    from romanimpreprocess_tpu_torch.calib import characterize

    lin, ramps, ts, bias = _toy_ramps()
    cpu = characterize.fit_linearity(ramps, ts, bias, device="cpu")
    monkeypatch.setattr(characterize, "LINFIT_SLAB_PIXELS", 4096)  # 4 slabs
    card = characterize.fit_linearity(ramps, ts, bias, device=cuda_device)
    default = characterize.fit_linearity(ramps, ts, bias)
    for k in ("Smin", "Smax", "Sref", "dq"):
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)
    np.testing.assert_array_equal(default["data"], card["data"])
    max_s = torch.from_numpy(ramps[0][-1])
    b = torch.from_numpy(bias)
    for frac in (0.15, 0.4, 0.7, 0.95):
        S = (b + frac * (max_s - b))[None]
        out = [linearity.apply_linearity_cube(S, linearity.LinearityData(
            *(torch.from_numpy(f[k]) for k in ("data", "Smin", "Smax", "Sref")),
            torch.from_numpy(f["dq"].view(np.int32))))[0].numpy() for f in (cpu, card)]
        rel = np.abs(out[1] - out[0]) / np.maximum(np.abs(out[0]), 100.0)
        assert np.median(rel) < 1e-4 and rel.max() < 1e-3, (frac, np.median(rel), rel.max())


@pytest.mark.cuda
@pytest.mark.parametrize("n_exp", [4, 12, 100])
def test_calib_sigma_clip_mean_on_cuda_matches_cpu(cuda_device, n_exp):
    """Survivor counts equal; means within rtol 1e-6 (summation order).
    Cosmic-ray outliers, NaN in single exposures and all-NaN pixels."""
    from romanimpreprocess_tpu_torch.calib import make_dark

    rng = np.random.default_rng(n_exp)
    stack = rng.normal(1000.0, 5.0, (n_exp, 128, 132)).astype(np.float32)
    hit = rng.random(stack.shape) < 0.01
    stack[hit] += rng.uniform(50, 5000, hit.sum()).astype(np.float32)
    stack[rng.random(stack.shape) < 0.005] = np.nan
    stack[:, 7, 9] = np.nan
    m_cpu, c_cpu = make_dark.sigma_clip_mean(torch.from_numpy(stack), counts=True)
    m_gpu, c_gpu = make_dark.sigma_clip_mean(torch.from_numpy(stack).to(cuda_device),
                                             counts=True)
    np.testing.assert_array_equal(c_gpu.cpu().numpy(), c_cpu.numpy())
    np.testing.assert_allclose(m_gpu.cpu().numpy(), m_cpu.numpy(), rtol=1e-6, atol=0)
    assert int(c_cpu[7, 9]) == 0


@pytest.mark.cuda
def test_calib_predicted_dark_cube_on_cuda_matches_cpu(cuda_device):
    """The per-read inverse-linearity forward model, with a read outside
    every group: rtol 1e-5 plus atol 1e-5 max|ref|."""
    from romanimpreprocess_tpu_torch.calib import postprocess

    lin, _, _, _ = _toy_ramps()
    dark = np.random.default_rng(5).uniform(0.01, 2.0, (128, 128)).astype(np.float32)
    rp = [[0], [1, 2], [4, 5, 6], [7, 8, 9, 10]]
    cpu = postprocess.predicted_dark_cube(dark, lin, rp, 3.04, 1.5, device="cpu")
    card = postprocess.predicted_dark_cube(dark, lin, rp, 3.04, 1.5, device=cuda_device)
    default = postprocess.predicted_dark_cube(dark, lin, rp, 3.04, 1.5)
    np.testing.assert_allclose(card, cpu, rtol=1e-5, atol=1e-5 * np.abs(cpu).max())
    np.testing.assert_array_equal(default, card)


# (ngrp, nside, nborder, slabs): the frame cut into 2 to 5 row slabs with
# their halos, at a frame narrower than one warp strip (20), sizes that
# are multiples of neither the strip nor the segment, nborder 4, 2, 1, 0
ROWS_CASES = [(1, 20, 4, 2), (6, 67, 4, 3), (9, 131, 4, 5), (17, 131, 2, 4),
              (3, 1000, 1, 3), (5, 130, 0, 2), (6, 1000, 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("ngrp,nside,nb,n", ROWS_CASES)
def test_ipc_rows_cuda_matches_plain(cuda_device, ngrp, nside, nb, n):
    """The frame inverse's row-slab form (``ipc_cuda.ipc_rev2_rows``) on
    the slabs of ``utils.rows.split_rows``: each slab bit for bit to its
    twin, and the slabs together bit for bit to the frame kernel, with
    and without a NaN and infinities in the border rows and columns read
    (``time_frame.check_rows``).  One launch a slab, and one for the
    frame."""
    gen = torch.Generator(device=cuda_device).manual_seed(nside + ngrp + nb + n)
    for nonfinite in (False, True):
        n0 = ipc_cuda.launches
        res = time_frame.check_rows(ngrp, nside, nb, n, gen, nonfinite)
        torch.cuda.synchronize()
        assert res["bit_exact"], res
        assert ipc_cuda.launches == n0 + n + 1


@pytest.mark.cuda
def test_spatial_core_on_one_card_two_entries(cuda_device):
    """The row-sharded core at 4096^2 on a one-card mesh of two entries
    (``cuda:0`` twice), every backend ``auto``: kernels A, B (its
    row-slab form, one launch a slab) and C, and the outputs at the JAX
    package's ``tests/test_spatial.py`` gate against the single core
    (``parity.row_shard_gate``)."""
    from romanimpreprocess_tpu_torch import benchlib
    from romanimpreprocess_tpu_torch.parallel import spatial

    arr, plan, cfg, geom = benchlib.core_bundle(nside=4096, device=cuda_device)
    ref = l1_to_l2.make_core(plan, cfg, geom)(arr)
    mesh = spatial.row_mesh(devices=[cuda_device, cuda_device])
    core = spatial.make_spatial_calibrator(plan, cfg, geom, mesh)
    counts = (linearity_cuda.launches, ipc_cuda.launches, median_cuda.launches)
    out = spatial.gather_rows(core(spatial.shard_rows(mesh, arr, geom)), cuda_device)
    torch.cuda.synchronize()
    assert (linearity_cuda.launches - counts[0], ipc_cuda.launches - counts[1],
            median_cuda.launches - counts[2]) == (2, 2, 1)
    parity.row_shard_gate(ref, out, "4096^2 over two entries")


# (ngrp, nside, nborder, slabs, th, padded): the slab routes' row form
SLAB_ROWS_CASES = [(3, 96, 4, 2, 16, True), (9, 131, 4, 5, 32, True),
                   (1, 20, 4, 2, 8, False), (17, 67, 2, 3, 8, False),
                   (6, 1000, 4, 4, 32, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("ngrp,nside,nb,n,th,padded", SLAB_ROWS_CASES)
def test_slab_rows_cuda_matches_plain(cuda_device, ngrp, nside, nb, n, th, padded):
    """The slab routes on row slabs (``correct_cube_fused`` /
    ``correct_cube_stream`` with ``row0, lo, hi``: the slab kernel with a
    row count of its own) on the slabs of ``utils.rows.split_rows``: each
    slab bit for bit to its twin, and the slabs together bit for bit to
    ``correct_cube_fused`` on the whole frame; one launch a slab, counted
    on the fused and the streaming counters."""
    gen = torch.Generator(device=cuda_device).manual_seed(nside + ngrp + n)
    data, planes, gain = time_frame.inputs(ngrp, nside, nb, gen)
    na = nside - 2 * nb
    act = slice(nb, nside - nb)
    K = planes[:, act, act].reshape(3, 3, na, na).contiguous()
    kern = (torch.from_numpy(ipc_slab.kernel_planes_padded(K.cpu().numpy(), th=th))
            .to(cuda_device) if padded else K)
    whole = ipc_slab.correct_cube_fused(data, kern, gain[act, act], nb, th)
    counts = (ipc_slab.fused_launches, ipc_slab.stream_launches)
    got = {"fused": [], "stream": []}
    for d, _, g, row0, lo, hi in time_frame.slabs(data, planes, gain, n):
        g = g[Rows(row0, d.shape[1], lo, hi).active(nside, nb), act]
        twin = ipc_slab.correct_cube_plain(d, kern, g, nb, th, row0, lo, hi)
        for name, fn in (("fused", ipc_slab.correct_cube_fused),
                         ("stream", ipc_slab.correct_cube_stream)):
            out = fn(d, kern, g, nb, th, row0, lo, hi)
            assert time_frame.same_bits(out, twin), name
            got[name].append(out)
    torch.cuda.synchronize()
    for name in got:
        assert time_frame.same_bits(torch.cat(got[name], dim=1), whole), name
    assert (ipc_slab.fused_launches - counts[0],
            ipc_slab.stream_launches - counts[1]) == (n, n)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["pallas", "pallas-stream"])
def test_spatial_core_slab_routes_on_cuda(cuda_device, route):
    """The row-sharded core with the likelihood fit under ``IPC_BACKEND:
    pallas`` / ``pallas-stream`` (kernels 6 / 5 in their row form) on a
    one-card mesh of three entries at 512^2, against the single core."""
    from romanimpreprocess_tpu_torch import benchlib
    from romanimpreprocess_tpu_torch.parallel import spatial

    arr, plan, cfg, geom = benchlib.core_bundle(nside=512, likelihood=True,
                                                device=cuda_device,
                                                config={"IPC_BACKEND": route})
    assert cfg["ipc"] in ("slab", "slab-stream")
    ref = l1_to_l2.make_core(plan, cfg, geom)(arr)
    mesh = spatial.row_mesh(devices=[cuda_device] * 3)
    counter = "fused_launches" if cfg["ipc"] == "slab" else "stream_launches"
    n0 = getattr(ipc_slab, counter)
    out = spatial.make_spatial_calibrator(plan, cfg, geom, mesh)(
        spatial.shard_rows(mesh, arr, geom))
    torch.cuda.synchronize()
    assert getattr(ipc_slab, counter) == n0 + 3
    parity.row_shard_gate(ref, spatial.gather_rows(out, cuda_device), route)


@pytest.mark.cuda
def test_sky_and_fit_steps_on_the_card_equal_the_cpu(cuda_device):
    """The steps that hold the port op by op to the JAX package
    (``tests/test_torch_opbyop.py``) give the CPU's bits on the card:
    ``ramp.sqrt_rn`` (through float64 on both), ``sky.tree_sum_leaves``
    (a ``cumsum`` down
    columns on the card, adds one by one on the CPU; signed zeros alike),
    ``sky.linspace32`` and ``sky.nanquantile``."""
    from romanimpreprocess_tpu_torch.ops import ramp

    rng = np.random.default_rng(5)
    x = torch.from_numpy((10.0 ** rng.uniform(-30, 30, 1 << 20)).astype(np.float32))
    got = ramp.sqrt_rn(x.to(cuda_device)).cpu().numpy()
    np.testing.assert_array_equal(got, np.sqrt(x.numpy()))
    w = torch.from_numpy((rng.normal(0.0, 1.0, (40000, 19))
                          * 10.0 ** rng.uniform(-3, 3, (40000, 19))).astype(np.float32))
    w[:, 3] = -0.0
    for n in (40000, 1250, 33, 7):  # trees of 3, 2, 1 and 0 levels, 19 bins
        leaves = sky.tree_leaves(n, "cpu")
        t = torch.cat([w[:n], w.new_zeros(1, 19)])[leaves]
        got = sky.tree_sum_leaves(t.to(cuda_device), leaves.dim()).cpu()
        assert torch.equal(got.view(torch.int32), sky.tree_sum_leaves(t, leaves.dim()).view(torch.int32))
        t = t[..., 0]  # one column
        got = sky.tree_sum_leaves(t.to(cuda_device), leaves.dim()).cpu()
        assert torch.equal(got.view(torch.int32), sky.tree_sum_leaves(t, leaves.dim()).view(torch.int32))
    for args in ((-1.0, 1.0, 21), (0.5, 7.5, 8), (-1.0, 1.0 - 2.0 / 4088, 4088)):
        assert torch.equal(sky.linspace32(*args, cuda_device).cpu(), sky.linspace32(*args, "cpu"))
    v = torch.from_numpy(rng.normal(0.0, 1.0, 100001).astype(np.float32))
    v[::7] = float("nan")
    qs = np.arange(1, 100, dtype=np.float32) / np.float32(100)
    assert torch.equal(sky.nanquantile(v.to(cuda_device), qs).cpu(), sky.nanquantile(v, qs))


# ---- the copy back through page-locked host memory (io/staging.fetch) ----


def _bits(shape, seed, device):
    """int32 of every bit pattern (NaN and infinities too as float32)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, shape, generator=g, dtype=torch.int32,
                         device=device)


def _pinned_blocks():
    """Blocks the caching host allocator has made so far."""
    return torch.cuda.host_memory_stats()["num_host_alloc"]


@pytest.mark.cuda
def test_fetch_and_to_host_from_the_card_bit_for_bit(cuda_device):
    """``fetch`` and ``to_host`` give ``t.cpu().numpy()`` bit for bit: float32
    (every pattern, NaN ones too) and an int32 DQ plane as uint32; writable
    arrays of the source's shape; every byte counted on both counters."""
    dq = _bits((512, 1024), 1, cuda_device)
    f = _bits((3, 512, 512), 2, cuda_device).view(torch.float32)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = staging.to_host({"slope": f, "pdq": dq})
        one = staging.fetch(f)
        one_dq = staging.fetch(dq, dq=True)
    counters = profiling.snapshot()["counters"]
    assert counters["d2h_bytes"] == 2 * (f.nbytes + dq.nbytes)
    assert counters["d2h_pinned_bytes"] == counters["d2h_bytes"]
    for a, t, dtype in ((got["slope"], f, np.float32), (one, f, np.float32),
                        (got["pdq"], dq, np.uint32), (one_dq, dq, np.uint32)):
        assert a.dtype == dtype and a.shape == tuple(t.shape) and a.flags.writeable
        np.testing.assert_array_equal(a.view(np.uint32), t.cpu().numpy().view(np.uint32))


@pytest.mark.cuda
def test_live_fetched_arrays_keep_their_own_blocks(cuda_device):
    """Three fetches of one size, all kept alive (the benchmark's reservoir
    of 3 results), hold their own values, in blocks of their own; once
    they are dropped a fetch of that size takes a freed block and makes
    no new one."""
    shape = (3, 700, 1000)  # 8.4 MB, a size class no other test takes
    kept = [staging.fetch(torch.full(shape, float(i), device=cuda_device)) for i in range(3)]
    for i, a in enumerate(kept):
        assert (a == i).all()
    ptrs = {a.ctypes.data for a in kept}
    assert len(ptrs) == 3
    kept[1][0, 0, 0] = -1.0  # writing one leaves the others as they were
    assert (kept[0] == 0).all() and (kept[2] == 2).all()
    del kept
    gc.collect()
    made = _pinned_blocks()
    again = staging.fetch(torch.full(shape, 7.0, device=cuda_device))
    assert (again == 7).all()
    assert _pinned_blocks() == made and again.ctypes.data in ptrs


@pytest.mark.cuda
def test_to_host_from_two_threads_returns_each_its_own(cuda_device):
    """``to_host`` from two threads at once (``parallel``'s entries):
    each thread gets its own outputs, call after call."""
    n = 40

    def work(k):
        out = []
        for i in range(n):
            v = float(1000 * k + i)
            got = staging.to_host({"slope": torch.full((256, 1024), v, device=cuda_device),
                                   "pdq": torch.full((256, 1024), int(v), dtype=torch.int32,
                                                     device=cuda_device)})
            out.append(bool((got["slope"] == v).all() and (got["pdq"] == int(v)).all()))
        return out

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(work, k) for k in (1, 2)]
            results = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(interval)
    assert results == [[True] * n, [True] * n]


def _same_as_numpy(got, ref, name):
    """A map made on the card against numpy's: NaN where numpy has NaN
    (the card may give another payload), every other value bit for bit."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    nan = np.isnan(ref)
    assert (np.isnan(got) == nan).all(), name
    np.testing.assert_array_equal(map_cases.bits(got)[~nan], map_cases.bits(ref)[~nan],
                                  err_msg=name)


def _pageable(a, device):
    """The copy to the device as it was before page-locked staging: the
    wire format made by numpy (uint16 and uint32 viewed as int16 and
    int32, anything else converted to float32), sent from pageable
    memory, uint16 widened on the device."""
    a = np.asarray(a)
    if a.dtype in (np.uint16, np.uint32):
        w = np.ascontiguousarray(a).view(np.int16 if a.dtype == np.uint16 else np.int32)
    else:
        w = np.ascontiguousarray(a, np.float32)
    t = torch.from_numpy(w).to(device)
    return t.to(torch.int32) & 0xFFFF if t.dtype == torch.int16 else t


def _stage_case(name):
    """A per-call host array of the kind ``name``, at full size where the
    L1 cube is."""
    rng = np.random.default_rng(24)
    if name == "uint16_cube":
        return rng.integers(0, 2**16, (8, 4096, 4096), dtype=np.uint16)
    if name == "uint32_dq":
        return rng.integers(0, 2**32, (4096, 4096), dtype=np.uint32)
    if name == "float32_bits":
        return rng.integers(0, 2**32, (3, 2048, 2048), dtype=np.uint32).view(np.float32)
    if name == "float64":
        with np.errstate(all="ignore"):
            a = np.ldexp(rng.standard_normal((2048, 2048)),
                         rng.integers(-1100, 1100, (2048, 2048)))
        a[0, :4] = [np.nan, -np.inf, np.inf, -0.0]
        return a
    if name == "uint16_strided":
        return rng.integers(0, 2**16, (8, 2048, 4096), dtype=np.uint16)[:, ::2, 1::3]
    if name == "float32_transposed":
        return rng.standard_normal((4096, 2048), dtype=np.float32).T
    if name == "float32_reversed":
        return rng.standard_normal((6, 1024, 1024), dtype=np.float32)[::-1]
    if name == "zero_d":
        return np.float32(-3.75)
    # 16 MiB planes, two a slice: slices of 2, 2 and 1
    assert name == "ragged_split"
    return rng.standard_normal((5, 1024, 4096), dtype=np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["uint16_cube", "uint32_dq", "float32_bits", "float64",
                                  "uint16_strided", "float32_transposed", "float32_reversed",
                                  "zero_d", "ragged_split"])
def test_stage_through_pinned_memory_bit_for_bit(cuda_device, name):
    """An uncached ``stage`` to the card (through page-locked blocks, slice
    by slice) gives what the pageable copy gave, bit for bit, in the
    array's shape, every byte counted on both counters."""
    a = _stage_case(name)
    with np.errstate(over="ignore"):  # float64 beyond float32's range
        want = _pageable(a, cuda_device)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = staging.stage(a, cuda_device, cache=False)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters["h2d_pinned_bytes"] == counters["h2d_bytes"] == staging.from_host(a).nbytes
    assert got.device.type == "cuda" and got.dtype == want.dtype and got.shape == np.shape(a)
    bits = torch.int32 if got.dtype == torch.float32 else got.dtype
    assert torch.equal(got.reshape(-1).view(bits), want.reshape(-1).view(bits))


@pytest.mark.cuda
def test_stage_frees_the_host_array_on_return(cuda_device):
    """Once ``stage`` returns, the caller may overwrite or free its array
    before any sync: the tensor on the card keeps what was staged."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**16, (8, 4096, 4096), dtype=np.uint16)
    want = torch.from_numpy(a.view(np.int16).copy())
    t = staging.stage(a, cuda_device, cache=False)
    a[...] = 0
    b = rng.standard_normal((4, 4096, 4096), dtype=np.float32)
    want_b = torch.from_numpy(b.copy())
    tb = staging.place(b, cuda_device)
    del b
    gc.collect()
    junk = [np.full((4, 4096, 4096), np.nan, np.float32) for _ in range(2)]
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(t.to(torch.int16).cpu(), want)
    assert torch.equal(tb.cpu(), want_b)
    del junk


@pytest.mark.cuda
def test_stage_recycles_its_pinned_block(cuda_device):
    """Twenty uncached stages of one size after the first make no new
    page-locked block: each call's block is handed out again once its
    copies have run (a call's own sync, here after each stage)."""
    a = np.zeros((8, 2048, 4096), np.uint16)

    def once(i):
        a[-1, -1, -1] = i
        t = staging.stage(a, cuda_device, cache=False)
        torch.cuda.current_stream(cuda_device).synchronize()
        return int(t[-1, -1, -1]) == i and not bool(t[:-1].any())

    assert once(0)  # the first makes the block (and the reads' own)
    made = _pinned_blocks()
    assert all(once(i) for i in range(1, 21))
    assert _pinned_blocks() == made


@pytest.mark.cuda
def test_stage_from_two_threads_gives_each_its_own(cuda_device):
    """Uncached stages from two threads at once (``parallel``'s lanes):
    each thread's tensor holds its own array, call after call."""
    n = 40

    def work(k):
        out = []
        for i in range(n):
            v = 1000 * k + i
            t = staging.stage(np.full((4, 512, 1024), v, np.uint16), cuda_device, cache=False)
            f = staging.place(np.full((512, 1024), v + 0.5, np.float64), cuda_device)
            out.append(bool((t == v).all() and (f == v + 0.5).all()))
        return out

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(work, k) for k in (1, 2)]
            results = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(interval)
    assert all(all(r) for r in results)


@pytest.mark.cuda
def test_prepare_inputs_stages_every_call_through_pinned_memory(cuda_device, tmp_path):
    """Once the cal pack is on the card, every byte ``prepare_inputs`` sends
    (the L1 cube, amp33, the area map, the small per-call arrays, the
    amp33 slope) goes through page-locked memory."""
    d = str(tmp_path)
    rp = synth.READ_PATTERN_DEFAULT
    caldir = synth.make_cal_files(d + "/cal", rp, nside=64, seed=5)
    cal = synth.synth_cal_arrays(64, rp, seed=5)
    synth.write_l1_file(d + "/L1.asdf", synth.synth_l1_cube(cal, rp, rate_dn_s=10.0, nborder=4),
                        rp, amp33=synth.synth_amp33(64, len(rp), 4))
    config = {"IN": d + "/L1.asdf", "CALDIR": caldir, "SKYORDER": 2}
    pack = calfiles.load_caldir_cached(caldir)
    l1 = asdf_lite.open(config["IN"])["roman"]
    area = np.ones((64, 64), np.float32)
    first = l1_to_l2.prepare_inputs(l1, config, pack, area, device=cuda_device)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        again = l1_to_l2.prepare_inputs(l1, config, pack, area, device=cuda_device)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters["h2d_pinned_bytes"] == counters["h2d_bytes"] > l1["data"].nbytes
    assert "pack_staged_bytes" not in counters
    for k in ("data", "amp33", "area_factor", "opt_slope"):
        assert torch.equal(first["arr"][k], again["arr"][k]), k
    assert again["arr"]["opt_slope"].shape == ()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 4096])
def test_product_maps_on_the_card_match_numpy(cuda_device, n):
    """``l1_to_l2.product_maps`` on the card against the host numpy
    packaging (``tests/map_cases.py``: random values and the edges of
    ``hypot`` and of the float16 cast), at 4096^2 too."""
    out = map_cases.inputs(n=n, nb=4)
    got = l1_to_l2.product_maps({k: torch.from_numpy(v).to(cuda_device)
                                 for k, v in out.items()}, 4)
    ref = map_cases.numpy_maps(out, 4)
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert got[k].device.type == "cuda" and got[k].is_contiguous(), k
        _same_as_numpy(got[k].cpu().numpy(), r, k)


@pytest.mark.cuda
def test_calibrate_tree_makes_the_maps_on_the_card_in_one_sync(cuda_device, tmp_path,
                                                               monkeypatch):
    """One ``calibrate_tree`` call with the likelihood fit on the card: the
    maps are made there (``maps_device`` once), come back with the core's
    outputs through one ``to_host`` and one sync, and equal the host numpy
    packaging of ``out``, which keeps the core's keys alone."""
    d = str(tmp_path)
    rp = synth.READ_PATTERN_DEFAULT
    caldir = synth.make_cal_files(d + "/cal", rp, nside=64, seed=5)
    cal = synth.synth_cal_arrays(64, rp, seed=5)
    synth.write_l1_file(d + "/L1.asdf", synth.synth_l1_cube(cal, rp, rate_dn_s=10.0, nborder=4),
                        rp, amp33=synth.synth_amp33(64, len(rp), 4))
    config = {"IN": d + "/L1.asdf", "CALDIR": caldir, "SKYORDER": 2,
              "romancal_ramp_fit": True}
    pack = calfiles.load_caldir_cached(caldir)
    l1 = asdf_lite.open(config["IN"])["roman"]
    syncs, fetched = [], []
    real_sync, real_to_host = torch.cuda.Stream.synchronize, l1_to_l2.to_host

    def sync(stream):
        syncs.append(stream)
        return real_sync(stream)

    def to_host(out):
        n0 = len(syncs)
        got = real_to_host(out)
        fetched.append((set(out), {v.device.type for v in out.values()}, len(syncs) - n0))
        return got

    monkeypatch.setattr(torch.cuda.Stream, "synchronize", sync)
    monkeypatch.setattr(l1_to_l2, "to_host", to_host)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tree, out = l1_to_l2.calibrate_tree(l1, config, pack, device=cuda_device)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters["maps_device"] == 1 and "maps_host" not in counters
    keys = set(l1_to_l2.PRODUCT_OUTPUTS) | {"dumo", "chisq"}
    maps = {"err", "var_poisson", "var_rnoise", "dumo", "chisq"}
    assert fetched == [(keys | {"maps." + k for k in maps}, {"cuda"}, 1)]
    assert set(out) == keys
    for k, r in map_cases.numpy_maps(out, 4).items():
        _same_as_numpy(np.asarray(tree["roman"][k]), r, k)
