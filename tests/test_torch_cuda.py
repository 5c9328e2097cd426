"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA GPU and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is
not installed; ``tests/conftest.py`` imports JAX, so on such a machine
run it without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernels repeat their plain twins' rounded steps in the
same order (no FMA contraction), so linearity (cube and DQ), the block
nanmedian and the L1 -> L2 product are held bit for bit; the IPC inverse
is held to 1e-5 of the largest value, the JAX package's own gate for its
Pallas kernel.
"""

import numpy as np
import pytest
import torch

from romanimpreprocess_tpu_torch import synth
from romanimpreprocess_tpu_torch.dqflags import i32, pixel
from romanimpreprocess_tpu_torch.io import asdf_lite
from romanimpreprocess_tpu_torch.ops import (ipc_cuda, linearity,
                                             linearity_cuda, median_cuda, sky)
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2

torch.set_num_threads(1)

CUDA_REASON = "needs CUDA; verified by chip_smoke.py on the H100"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(CUDA_REASON)
    return torch.device("cuda")


def _same(a, b):
    return bool(((a == b) | (np.isnan(a) & np.isnan(b))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("ngrp,nside", [(3, 128), (2, 120)])
def test_ipc_frame_cuda_matches_plain(cuda_device, ngrp, nside):
    rng = np.random.RandomState(nside)
    na = nside - 8
    K = rng.uniform(0, 0.02, (3, 3, na, na)).astype(np.float32)
    K[1, 1] = 1 - K.sum(axis=(0, 1)) + K[1, 1]
    planes = torch.from_numpy(ipc_cuda.kernel_planes_frame(K, nside, 4)).to(cuda_device)
    d = torch.from_numpy(rng.uniform(0, 1000, (ngrp, nside, nside))
                         .astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.uniform(1.4, 1.6, (nside, nside))
                         .astype(np.float32)).to(cuda_device)
    n0 = ipc_cuda.launches
    got = ipc_cuda.ipc_rev2_frame(d, planes, g)
    ref = ipc_cuda.ipc_rev2_frame_plain(d, planes, g)
    torch.cuda.synchronize()
    assert ipc_cuda.launches == n0 + 1
    assert torch.equal(got[:, :4], d[:, :4]) and torch.equal(got[:, :, -4:], d[:, :, -4:])
    assert ((got - ref).abs().max() / ref.abs().max()).item() < 1e-5


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


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,N", [(130, 125, 8), (128, 120, 4)])
def test_block_nanmedian_cuda_bit_identical(cuda_device, ny, nx, N):
    rng = np.random.RandomState(1)
    arr = (rng.randn(ny, nx) * 100).astype(np.float32)
    arr[rng.rand(ny, nx) < 0.2] = np.nan
    ky, kx, py, px = sky.block_geometry(ny, nx, N)
    arr[py : py + ky, px : px + kx] = np.nan  # one all-NaN block
    a = torch.from_numpy(arr).to(cuda_device)
    frame = torch.zeros((ny + 8, nx + 8), device=cuda_device)
    frame[4:-4, 4:-4] = a
    for view in (a, frame[4:-4, 4:-4]):  # contiguous and row-strided
        n0 = median_cuda.launches
        got = median_cuda.block_nanmedian_fused(view, N).cpu().numpy()
        ref = sky.block_nanmedian(view, N).cpu().numpy()
        assert median_cuda.launches == n0 + 1
        assert _same(got, ref)
        assert np.isnan(got[0, 0])


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
