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
- block nanmedian (``block_nanmedian_fused``): bit-exact;
- read contraction (``contract_reads``): atol 1e-5 max|ref| (the JAX
  package's own gate against einsum; both sum in read order);
- forward IPC (``ipc_fwd_cube_blocked``): 1e-6 of the peak (nine
  products summed in another order), with and without gain;
- slab IPC inverses (``ipc_rev2_cube_blocked``, ``ipc_rev2_cube_stream``,
  ``correct_cube_fused``): the twin takes the same float32 steps in the
  same order (taps 0..8, ``(3y - 3a) + b``), held to 1e-6 of max|ref|.
  Measured: up to 6.1e-7, not equal bits: XLA's CPU compiler contracts
  the multiply-adds into FMAs (a float64 emulation of that contraction
  moves the share of differing values from 70% to 7%); the CUDA kernel
  and the twin, which both round every step, agree bit for bit on the
  card.  Border equal to the input exactly; the padded-layout helpers
  equal to the JAX package's exactly;
- pink transform (``pink_frames_fused``, and ``pink.pink_frames``): the
  test draws the white spectrum with the reference's key and hands it to
  the port.  Same cast points, another order of sums, so the JAX
  package's gate for its two paths applies (difference std < 1e-2 and
  max < 5e-2 of the frame std).  Measured here: against the JAX XLA
  path 2.4e-5 and 6e-4, held to 1e-4 and 3e-3; against the Pallas kernel
  in interpret mode 1.6e-3 and 1.4e-2 (that is the distance between the
  JAX package's own two paths on the CPU), held to 3e-3 and 3e-2.

The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
compares each one with its plain version there.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romanimpreprocess_tpu.dqflags import pixel as jpixel
from romanimpreprocess_tpu.ops import (contract_pallas, ipc_pallas,
                                       linearity_pallas, median_pallas,
                                       pink_pallas)
from romanimpreprocess_tpu.ops import linearity as jlinearity
from romanimpreprocess_tpu.ops import pink as jpink
from romanimpreprocess_tpu_torch.dqflags import i32, pixel
from romanimpreprocess_tpu_torch.ops import (contract_cuda, ipc_cuda, ipc_slab,
                                             linearity, linearity_cuda,
                                             median_cuda, pink, pink_cuda, sky)

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
# 4, 5, 6: slab-layout IPC inverses
# --------------------------------------------------------------------------

def _slab_case(na, G, with_gain, seed=0):
    rng = np.random.RandomState(seed + na + G)
    cube = rng.uniform(0, 1000, (G, na, na)).astype(np.float32)
    K = rng.uniform(0, 0.02, (3, 3, na, na)).astype(np.float32)
    K[1, 1] = 1 - K.sum(axis=(0, 1)) + K[1, 1]
    gain = rng.uniform(1.4, 1.6, (na, na)).astype(np.float32) if with_gain else None
    return cube, K, gain


def _opt(a, conv):
    return None if a is None else conv(a)


SLAB_FNS = {
    "blocked": (ipc_pallas.ipc_rev2_cube_blocked, ipc_slab.ipc_rev2_cube_blocked),
    "stream": (ipc_pallas.ipc_rev2_cube_stream, ipc_slab.ipc_rev2_cube_stream),
}


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("with_gain", [False, True])
@pytest.mark.parametrize("na,th,G", [(96, 16, 2), (100, 8, 3), (100, 16, 1)])
@pytest.mark.parametrize("which", list(SLAB_FNS))
def test_ipc_slab_matches_pallas(which, na, th, G, with_gain, padded):
    jfn, tfn = SLAB_FNS[which]
    cube, K, gain = _slab_case(na, G, with_gain)
    kj = ipc_pallas.kernel_planes_padded(K, th=th) if padded else K
    kt = ipc_slab.kernel_planes_padded(K, th=th) if padded else K
    want = np.asarray(jfn(jnp.asarray(cube), jnp.asarray(kj),
                          _opt(gain, jnp.asarray), th=th, interpret=True))
    got = tfn(torch.from_numpy(cube), torch.from_numpy(kt),
              _opt(gain, torch.from_numpy), th=th).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("with_gain", [False, True])
@pytest.mark.parametrize("nside,nb,th,G", [(104, 4, 8, 2), (108, 4, 16, 3),
                                           (100, 0, 16, 1)])
def test_correct_cube_fused_matches_pallas(nside, nb, th, G, with_gain, padded):
    na = nside - 2 * nb
    _, K, gain = _slab_case(na, G, with_gain)
    data = np.random.RandomState(nside).uniform(
        0, 1000, (G, nside, nside)).astype(np.float32)
    kj = ipc_pallas.kernel_planes_padded(K, th=th) if padded else K
    kt = ipc_slab.kernel_planes_padded(K, th=th) if padded else K
    want = np.asarray(ipc_pallas.correct_cube_fused(
        jnp.asarray(data), jnp.asarray(kj), gain=_opt(gain, jnp.asarray),
        nborder=nb, th=th, interpret=True))
    got = ipc_slab.correct_cube_fused(
        torch.from_numpy(data), torch.from_numpy(kt),
        gain=_opt(gain, torch.from_numpy), nborder=nb, th=th).numpy()
    border = np.ones((nside, nside), bool)
    border[nb : nside - nb, nb : nside - nb] = False
    np.testing.assert_array_equal(got[:, border], data[:, border])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # nborder from the raw kernel's shape; the pre-padded form needs it
    auto = ipc_slab.correct_cube_fused(torch.from_numpy(data), torch.from_numpy(K),
                                       gain=_opt(gain, torch.from_numpy), th=th)
    np.testing.assert_array_equal(auto.numpy(), got)
    kp = torch.from_numpy(ipc_slab.kernel_planes_padded(K, th=th))
    with pytest.raises(ValueError, match="nborder"):
        ipc_slab.correct_cube_fused(torch.from_numpy(data), kp, th=th)


def test_ipc_slab_twin_is_one_function_for_all_entries():
    cube, K, gain = _slab_case(100, 2, True)
    c, k, g = torch.from_numpy(cube), torch.from_numpy(K), torch.from_numpy(gain)
    a = ipc_slab.ipc_rev2_cube_blocked(c, k, g, th=16)
    kp = torch.from_numpy(ipc_slab.kernel_planes_padded(K, th=8))
    b = ipc_slab.ipc_rev2_cube_stream(c, kp, g, th=8)
    assert torch.equal(a, b)
    assert torch.equal(a, ipc_slab.ipc_rev2_plain(c, k.reshape(9, 100, 100), g))
    # not the frame route's order of summation (centre tap first)
    from romanimpreprocess_tpu_torch.ops import ipc
    other = ipc.ipc_rev(c, k, order=2, gain=g)
    assert not torch.equal(a, other)
    assert (a - other).abs().max() <= 1e-5 * other.abs().max()


@pytest.mark.parametrize("na,th", [(96, 16), (100, 8), (4088, 32)])
def test_ipc_slab_padded_layout_matches_jax_helpers(na, th):
    assert ipc_slab._pad_geom(na, th) == ipc_pallas._pad_geom(na, th)
    assert ipc_slab.TAPS == ipc_pallas.TAPS
    if na > 200:
        assert ipc_slab._pad_geom(na, th) == (4096, 4096, 128, 4160)
        return
    _, K, _ = _slab_case(na, 1, False)
    got = ipc_slab.kernel_planes_padded(K, th=th)
    np.testing.assert_array_equal(got, ipc_pallas.kernel_planes_padded(K, th=th))
    assert got.dtype == np.float32
    assert ipc_slab.kernel_planes_padded(K, th=th) is got  # cached per kernel
    np.testing.assert_array_equal(got[:, th : th + na, 2 : 2 + na],
                                  K.reshape(9, na, na))


@pytest.mark.parametrize("fn", [ipc_slab.ipc_rev2_cube_blocked,
                                ipc_slab.ipc_rev2_cube_stream])
def test_ipc_slab_prepadded_th_mismatch_raises(fn):
    cube, K, _ = _slab_case(96, 1, False)
    kp = torch.from_numpy(ipc_slab.kernel_planes_padded(K, th=8))
    with pytest.raises(ValueError, match="slab geometry"):
        fn(torch.from_numpy(cube), kp, th=16)
    with pytest.raises(ValueError, match="expected shape"):
        fn(torch.from_numpy(cube), torch.from_numpy(K[:, :, :90, :90].copy()), th=16)


def test_ipc_slab_bytes_bound_at_full_size():
    # 6 groups of 4088^2: cube in + out, 9 planes, gain
    assert ipc_slab.bytes_moved(6, 4088) == 4 * 4088 * 4088 * 22
    assert ipc_slab.bytes_moved(6, 4088, has_gain=False) == 4 * 4088 * 4088 * 21
    # the fused form moves the whole frame in and out
    assert ipc_slab.fused_bytes_moved(6, 4096, 4) == 4 * (12 * 4096**2 + 10 * 4088**2)


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
    k4 = torch.zeros((3, 3, 8, 8), device="meta")
    for fn in (ipc_slab.ipc_rev2_cube_blocked, ipc_slab.ipc_rev2_cube_stream,
               ipc_slab.correct_cube_fused):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(meta, k4)
    with pytest.raises(ValueError):
        contract_cuda.contract_reads(torch.zeros((2, 3), device="meta"),
                                     torch.zeros((3, 8, 8), device="meta"))
    with pytest.raises(ValueError):
        ipc_cuda.ipc_fwd_cube(meta, torch.zeros((3, 3, 8, 8), device="meta"))
    with pytest.raises(ValueError):
        pink_cuda.pink_from_white(torch.zeros((1, 2, 1 << 14), device="meta",
                                              dtype=torch.bfloat16))


# --------------------------------------------------------------------------
# 9: read-axis contraction
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ngrp,nreads,ny,nx,th", [(6, 14, 96, 128, 32),
                                                  (5, 11, 130, 256, 32),
                                                  (3, 7, 64, 384, 16)])
def test_contract_matches_pallas(ngrp, nreads, ny, nx, th):
    rng = np.random.RandomState(7 + ngrp)
    T = rng.normal(size=(ngrp, nreads)).astype(np.float32)
    x = rng.normal(size=(nreads, ny, nx)).astype(np.float32)
    want = np.asarray(contract_pallas.contract_reads(
        jnp.asarray(T), jnp.asarray(x), th=th, interpret=True))
    got = contract_cuda.contract_reads(torch.from_numpy(T), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, np.einsum("jr,ryx->jyx", T, x), rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_contract_plain_sums_in_read_order():
    # 2^24 + 1 + 1: in read order the ones are absorbed one by one
    T = torch.ones((1, 3))
    x = torch.tensor([2.0**24, 1.0, 1.0]).reshape(3, 1, 1)
    assert contract_cuda.contract_reads(T, x).item() == 2.0**24
    x = torch.tensor([1.0, 1.0, 2.0**24]).reshape(3, 1, 1)
    assert contract_cuda.contract_reads(T, x).item() == 2.0**24 + 2


def test_contract_bytes_bound_at_full_size():
    # 14 reads in, 6 groups out, 4088^2 pixels of 4 bytes, plus T
    assert contract_cuda.bytes_moved(6, 14, 4088, 4088) == 4 * 4088 * 4088 * 20 + 4 * 84


# --------------------------------------------------------------------------
# 7: forward IPC
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_gain", [False, True])
@pytest.mark.parametrize("na,G,th", [(56, 3, 8), (120, 2, 32)])
def test_ipc_fwd_matches_pallas(na, G, th, with_gain):
    rng = np.random.RandomState(na)
    K = rng.uniform(0, 0.02, (3, 3, na, na)).astype(np.float32)
    K[1, 1] = 1 - K.sum(axis=(0, 1)) + K[1, 1]
    cube = rng.uniform(0, 5e4, (G, na, na)).astype(np.float32)
    gain = rng.uniform(1.4, 1.6, (na, na)).astype(np.float32) if with_gain else None
    want = np.asarray(ipc_pallas.ipc_fwd_cube_blocked(
        jnp.asarray(cube), jnp.asarray(K),
        None if gain is None else jnp.asarray(gain), th=th, interpret=True))
    got = ipc_cuda.ipc_fwd_cube(
        torch.from_numpy(cube), torch.from_numpy(K),
        None if gain is None else torch.from_numpy(gain)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_ipc_fwd_bytes_bound_at_full_size():
    # cube in and out (6 groups each) and 9 planes of 4088^2 float32
    assert ipc_cuda.fwd_bytes_moved(6, 4088) == 4 * 4088 * 4088 * 21
    assert ipc_cuda.fwd_bytes_moved(6, 4088, True) == 4 * 4088 * 4088 * 22


# --------------------------------------------------------------------------
# 8: pink-noise transform
# --------------------------------------------------------------------------

def _rbg_key(i):
    return jax.random.key(i, impl="rbg")


def _white(key, ntr, length):
    """The reference's white draw for ``ntr`` transforms, as a torch
    bfloat16 tensor (through float32 numpy, which holds bf16 exactly)."""
    w = jax.random.normal(key, (ntr, 2, length), dtype=jnp.bfloat16)
    return torch.from_numpy(np.array(w.astype(jnp.float32))).to(torch.bfloat16)


# (nside, channelwidth, nframes): lengths 2^10, 2^11 (n1 != n2), 2^16
PINK_CASES = [(64, 8, 5), (128, 8, 4), (256, 128, 5)]


@pytest.mark.parametrize("nside,cw,nframes", PINK_CASES)
def test_pink_from_white_matches_pallas(nside, cw, nframes):
    length = 2 * nside * cw
    key = _rbg_key(7)
    want = np.asarray(pink_pallas.pink_frames_fused(key, nframes, nside, cw,
                                                    interpret=True))
    got = pink_cuda.pink_from_white(_white(key, (nframes + 1) // 2, length))
    got = got[:nframes].reshape(nframes, nside, cw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    s = want.std()
    d = np.abs(got - want)
    assert d.std() < 3e-3 * s, d.std() / s
    assert d.max() < 3e-2 * s, d.max() / s
    flat = got.reshape(nframes, -1)
    assert np.abs(flat.mean(axis=1)).max() < 1e-3 * flat.std()


def test_pink_from_white_matches_xla_path_at_full_threshold():
    nside, cw, nframes = 256, 128, 5  # 2^16 = MXU_MIN_LENGTH: the MXU path
    key = _rbg_key(11)
    want = np.asarray(jpink.pink_frames(key, nframes, nside, cw))
    got = pink.pink_from_white_plain(_white(key, 3, 2 * nside * cw))
    got = got[:nframes].reshape(nframes, nside, cw).numpy()
    s = want.std()
    d = np.abs(got - want)
    assert d.std() < 1e-4 * s and d.max() < 3e-3 * s, (d.std() / s, d.max() / s)


@pytest.mark.parametrize("n1,n2,both,half", [(32, 32, True, True), (32, 64, True, False),
                                            (16, 32, False, True)])
def test_fft_ct_matches_reference(n1, n2, both, half):
    rng = np.random.RandomState(n1 + n2)
    sr = rng.normal(size=(3, n1 * n2)).astype(np.float32)
    si = rng.normal(size=(3, n1 * n2)).astype(np.float32)
    want = jpink._fft_ct(jnp.asarray(sr), jnp.asarray(si), n1, n2, both=both, half=half)
    got = pink._fft_ct(torch.from_numpy(sr), torch.from_numpy(si), n1, n2,
                       both=both, half=half)
    if not both:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape
        d = np.abs(g.numpy() - w)
        assert d.std() < 1e-3 * w.std() and d.max() < 2e-2 * w.std()
    # against the exact transform: the bf16 envelope of the module docstring
    exact = np.fft.fft(sr.astype(np.float64) + 1j * si, axis=-1)
    exact = exact[:, : n1 * n2 // 2] if half else exact
    assert np.abs(got[0].numpy() - exact.real).std() < 0.01 * exact.real.std()


def test_pink_constants_match_reference_cast_points():
    n1, n2 = 32, 64
    e1c, e1s, e2c, e2s, wc, ws = pink.dft_matrices(n1, n2, n2 // 2)
    assert e1c.dtype == e2s.dtype == torch.bfloat16 and wc.dtype == torch.float32
    a1 = jnp.arange(n1, dtype=jnp.float32)
    a2 = jnp.arange(n2, dtype=jnp.float32)
    th2 = (2.0 * jnp.pi / n2) * jnp.outer(a2, a2[: n2 // 2])
    want = np.asarray(jnp.sin(th2).astype(jnp.bfloat16).astype(jnp.float32))
    # cos/sin of two libraries may differ in the last float32 bit, which
    # flips a bf16 rounding on a few entries: one bf16 ulp at most
    assert np.abs(e2s.float().numpy() - want).max() <= 2.0**-8
    assert (e2s.float().numpy() != want).mean() < 0.01
    thw = (2.0 * jnp.pi / (n1 * n2)) * jnp.outer(a2, a1)
    np.testing.assert_allclose(wc.numpy(), np.asarray(jnp.cos(thw)), atol=2e-7)
    c = pink_cuda.kernel_constants(n1, n2, torch.device("cpu"))
    assert c["b1r"].shape == (2 * n1, n1) and c["a2i"].shape == (n2 // 2, 2 * n2)
    assert torch.equal(c["b1i"][:n1], -e1s) and torch.equal(c["a2r"][:, :n2], e2c.T)
    assert c["amp"].shape == (n1, n2) and c["amp"][0, 0] == 0
    assert pink_cuda.kernel_constants(n1, n2, torch.device("cpu")) is c


def test_pink_amplitude_matches_reference():
    length = 1 << 11
    k = jnp.arange(length, dtype=jnp.float32)
    amp = (1.0e-99 + jnp.minimum(k, length - k)) ** (-0.5) / jnp.sqrt(2.0)
    want = np.asarray(amp.at[0].set(0.0).astype(jnp.bfloat16).astype(jnp.float32))
    got = pink.amplitude(length).float().numpy()
    assert np.abs(got - want).max() <= 2.0**-9 * want.max()
    assert (got != want).mean() < 0.01


def test_pink_flops_and_bytes_at_full_size():
    # 102 transforms of 2^20: 12.9 GFLOP each; bf16 white in, f32 frames out
    assert pink_cuda.flops(102, 1 << 20) == 102 * (2**33 + 2**32)
    assert pink_cuda.bytes_moved(102, 1 << 20) == 102 * (4 * 2**20 + 4 * 2**20)


def _spectral_slope(frames):
    flat = frames.reshape(frames.shape[0], -1)
    p = (np.abs(np.fft.rfft(flat, axis=1)) ** 2).mean(axis=0)
    k = np.arange(len(p))
    sel = slice(2, 2000)
    return np.polyfit(np.log(k[sel]), np.log(p[sel] + 1e-30), 1)[0]


def test_pink_frames_ct_branch_zero_mean_and_slope():
    gen = torch.Generator().manual_seed(11)
    b = pink.pink_frames(gen, 8, 256, 128).numpy()
    assert b.shape == (8, 256, 128) and b.dtype == np.float32
    flat = b.reshape(8, -1)
    assert np.abs(flat.mean(axis=1)).max() < 1e-3 * flat.std()
    assert abs(_spectral_slope(b) + 1.0) < 0.1
    # unit variance per logarithmic frequency range, as the reference
    want = np.asarray(jpink.pink_frames(_rbg_key(11), 8, 256, 128))
    assert abs(b.std() / want.std() - 1.0) < 0.1


def test_pink_frames_irfft_branch_below_threshold():
    # below MXU_MIN_LENGTH the exact irfft runs whatever the backend
    a = pink.pink_frames(torch.Generator().manual_seed(5), 3, 64, 8)
    b = pink.pink_frames(torch.Generator().manual_seed(5), 3, 64, 8, backend="cuda")
    assert torch.equal(a, b) and a.shape == (3, 64, 8)
    assert 2 * 64 * 8 < pink.MXU_MIN_LENGTH == jpink.MXU_MIN_LENGTH
    many = pink.pink_frames(torch.Generator().manual_seed(6), 64, 64, 8).numpy()
    want = np.asarray(jpink.pink_frames(_rbg_key(6), 64, 64, 8))
    assert np.abs(many.reshape(64, -1).mean(axis=1)).max() < 1e-3 * many.std()
    assert abs(many.std() / want.std() - 1.0) < 0.05
    p = (np.abs(np.fft.rfft(many.reshape(64, -1), axis=1)) ** 2).mean(axis=0)
    k = np.arange(len(p))
    slope = np.polyfit(np.log(k[2:200]), np.log(p[2:200]), 1)[0]
    assert abs(slope + 1.0) < 0.1
