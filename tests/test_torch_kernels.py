"""The port's kernel modules against the JAX package's Pallas kernels.

Each module of ``romanimpreprocess_tpu_torch`` that holds a CUDA kernel
is checked here on the CPU, where its wrapper takes the plain PyTorch
version, against the JAX Pallas kernel run in interpret mode on the same
numpy inputs:

- IPC frame inverse (``ipc_rev2_frame_stream``): rel err < 1e-5 of the
  largest value (sums in another order), border passthrough exact;
- linearity (``apply_linearity_cube_fused``): DQ bit-exact, phi within
  rtol 1e-6 and atol 1e-6 max|ref| (same elementwise steps, XLA may
  fuse them differently);
- block nanmedian (``block_nanmedian_fused``): bit-exact.

The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
compares each one with its plain version there.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romanimpreprocess_tpu.dqflags import pixel as jpixel
from romanimpreprocess_tpu.ops import ipc_pallas, linearity_pallas, median_pallas
from romanimpreprocess_tpu.ops import linearity as jlinearity
from romanimpreprocess_tpu_torch.dqflags import i32, pixel
from romanimpreprocess_tpu_torch.ops import (ipc_cuda, linearity,
                                             linearity_cuda, median_cuda, sky)

torch.set_num_threads(1)

def _dq_tensor(dq_u32):
    return torch.from_numpy(np.ascontiguousarray(dq_u32, np.uint32).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


# --------------------------------------------------------------------------
# B: IPC frame inverse
# --------------------------------------------------------------------------

def _ipc_case(nside, nb, G=3, seed=0):
    rng = np.random.RandomState(seed + nside)
    na = nside - 2 * nb
    data = rng.uniform(0, 1000, (G, nside, nside)).astype(np.float32)
    K = rng.uniform(0, 0.02, (3, 3, na, na)).astype(np.float32)
    K[1, 1] = 1 - K.sum(axis=(0, 1)) + K[1, 1]
    gain = rng.uniform(1.4, 1.6, (nside, nside)).astype(np.float32)
    return data, K, gain


@pytest.mark.parametrize("nside,th", [(64, 16), (64, 32), (128, 16), (128, 32)])
def test_ipc_frame_matches_pallas(nside, th):
    nb = 4
    data, K, gain = _ipc_case(nside, nb)
    kf = ipc_pallas.kernel_planes_frame(K, nside, nb)
    want = np.asarray(ipc_pallas.ipc_rev2_frame_stream(
        jnp.asarray(data), jnp.asarray(kf), jnp.asarray(gain), nborder=nb,
        th=th, interpret=True))
    planes = torch.from_numpy(ipc_cuda.kernel_planes_frame(K, nside, nb))
    got = ipc_cuda.ipc_rev2_frame(torch.from_numpy(data), planes,
                                  torch.from_numpy(gain), nborder=nb).numpy()
    border = np.ones((nside, nside), bool)
    border[nb:-nb, nb:-nb] = False
    np.testing.assert_array_equal(got[:, border], data[:, border])
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-5, rel


def test_ipc_frame_planes_match_jax_helper():
    data, K, gain = _ipc_case(64, 4)
    np.testing.assert_array_equal(ipc_cuda.kernel_planes_frame(K, 64, 4),
                                  ipc_pallas.kernel_planes_frame(K, 64, 4))


def test_ipc_bytes_bound_at_full_size():
    # 4096^2 x 6 groups: cube in + out, 9 planes, gain
    assert ipc_cuda.bytes_moved(6, 4096) == 4 * 4096 * 4096 * 22


# --------------------------------------------------------------------------
# A: linearity
# --------------------------------------------------------------------------

def _lin_case(ny, nx, ngrp=5, seed=7):
    rng = np.random.RandomState(seed)
    coefs = (rng.randn(4, ny, nx).astype(np.float32) * 0.1
             + np.array([0, 3e4, 0, 0], np.float32)[:, None, None])
    smin = (rng.rand(ny, nx) * 100).astype(np.float32)
    smax = smin + np.float32(40000)
    sref = smin + np.float32(200)
    dq = ((rng.rand(ny, nx) < 0.05).astype(np.uint32) * np.uint32(jpixel.NO_LIN_CORR)
          | (rng.rand(ny, nx) < 0.05).astype(np.uint32)
          * np.uint32(jpixel.REFERENCE_PIXEL))
    S = (smin[None] + rng.rand(ngrp, ny, nx).astype(np.float32) * 5e4
         - 2000).astype(np.float32)
    att = rng.rand(ngrp, ny, nx) < 0.9
    # pixel (0, 0): clean, in range until group 2 extrapolates, so the
    # fallback must take groups 3.. (the sequential DQ feedback)
    dq[0, 0] = 0
    att[:, 0, 0] = True
    S[:, 0, 0] = smin[0, 0] + np.array([1e4, 2e4, 4.5e4, 3e4, 3e4][:ngrp], np.float32)
    return S, coefs, smin, smax, sref, dq, att


def _port_lin(coefs, smin, smax, sref, dq):
    t = torch.from_numpy
    return linearity.LinearityData(t(coefs), t(smin), t(smax), t(sref), _dq_tensor(dq))


@pytest.mark.parametrize("dnff", [True, False])
@pytest.mark.parametrize("ny,nx", [(24, 128), (20, 130)])
def test_linearity_matches_pallas(dnff, ny, nx):
    S, coefs, smin, smax, sref, dq, att = _lin_case(ny, nx)
    jlin = jlinearity.LinearityData(*(jnp.asarray(a) for a in
                                      (coefs, smin, smax, sref, dq)))
    want, dq_want = linearity_pallas.apply_linearity_cube_fused(
        jnp.asarray(S), jlin, jnp.asarray(att), do_not_flag_first=dnff,
        th=8, interpret=True)
    want, dq_want = np.asarray(want), np.asarray(dq_want)
    got, dq_got = linearity_cuda.apply_linearity_cube_fused(
        torch.from_numpy(S), _port_lin(coefs, smin, smax, sref, dq),
        torch.from_numpy(att), do_not_flag_first=dnff)
    np.testing.assert_array_equal(_u32(dq_got), dq_want)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    # the feedback pixel: flagged, and groups after 2 fall back to S - sref
    assert dq_want[0, 0] & jpixel.NO_LIN_CORR
    np.testing.assert_array_equal(got[3:, 0, 0], S[3:, 0, 0] - sref[0, 0])
    assert got[1, 0, 0] != S[1, 0, 0] - sref[0, 0]


def test_linearity_dq_is_int32_bit_pattern():
    assert i32(pixel.REFERENCE_PIXEL) == -(2**31)
    assert i32(pixel.NO_LIN_CORR) == 2**20
    assert linearity.FALLBACK_BITS == i32(pixel.NO_LIN_CORR | pixel.REFERENCE_PIXEL)


def test_linearity_bytes_bound_at_full_size():
    n = 4096 * 4096
    # S 4G + coefs 16 + smin/smax/sref 12 + dq 4 + attempt G; phi 4G + dq 4
    assert linearity_cuda.bytes_moved(6, 4096, 4096, 4) == n * (24 + 16 + 12 + 4 + 6 + 24 + 4)


# --------------------------------------------------------------------------
# C: block nanmedian
# --------------------------------------------------------------------------

def _med_case(ny, nx, N, seed=1):
    rng = np.random.RandomState(seed)
    arr = (rng.randn(ny, nx) * 100).astype(np.float32)
    arr[rng.rand(ny, nx) < 0.2] = np.nan
    ky, kx, py, px = sky.block_geometry(ny, nx, N)
    arr[py : py + ky, px : px + kx] = np.nan  # one all-NaN block
    return arr


def _same(a, b):
    return bool(((a == b) | (np.isnan(a) & np.isnan(b))).all())


@pytest.mark.parametrize("ny,nx,N", [(64, 64, 8), (72, 68, 8), (128, 120, 4),
                                     (130, 125, 8)])
def test_block_nanmedian_bit_identical_to_pallas(ny, nx, N):
    arr = _med_case(ny, nx, N)
    want = np.asarray(median_pallas.block_nanmedian_fused(
        jnp.asarray(arr), N, interpret=True))
    got = median_cuda.block_nanmedian_fused(torch.from_numpy(arr), N).numpy()
    assert _same(got, want)
    assert np.isnan(got[0, 0])
    ky, kx, py, px = sky.block_geometry(ny, nx, N)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        oracle = np.nanmedian(arr[py : py + N * ky, px : px + N * kx]
                              .reshape(N, ky, N, kx), axis=(1, 3))
    assert _same(got, oracle)


def test_block_nanmedian_even_count_averages_middle_pair():
    # torch.median would return the lower middle value (2.0)
    arr = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    assert median_cuda.block_nanmedian_fused(arr, 1).item() == 2.5


def test_block_nanmedian_rejects_more_than_128_blocks():
    with pytest.raises(ValueError):
        median_cuda.block_nanmedian_fused(torch.zeros((258, 258)), 129)


def test_wrappers_raise_on_non_cuda_non_cpu_tensors():
    meta = torch.zeros((2, 8, 8), device="meta")
    with pytest.raises(ValueError):
        ipc_cuda.ipc_rev2_frame(meta, torch.zeros((9, 8, 8), device="meta"),
                                torch.zeros((8, 8), device="meta"))
    with pytest.raises(ValueError):
        median_cuda.block_nanmedian_fused(torch.zeros((8, 8), device="meta"), 2)
