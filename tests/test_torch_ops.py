"""The port's plain PyTorch ops against the JAX package's functions.

Same numpy inputs (from seeds) through both; tolerances, where a result
is not bit-exact, are stated at each assert with their reason.  DQ is
always bit-exact: the port holds it as int32 bit patterns and hands back
uint32 through ``.view``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romanimpreprocess_tpu.ops import flat as jflat
from romanimpreprocess_tpu.ops import ipc as jipc
from romanimpreprocess_tpu.ops import legendre as jlegendre
from romanimpreprocess_tpu.ops import mask as jmask
from romanimpreprocess_tpu.ops import ramp as jramp
from romanimpreprocess_tpu.ops import refsub as jrefsub
from romanimpreprocess_tpu.ops import saturation as jsaturation
from romanimpreprocess_tpu.ops import sky as jsky
from romanimpreprocess_tpu_torch.dqflags import pixel
from romanimpreprocess_tpu.utils import bitutils as jbitutils
from romanimpreprocess_tpu_torch.ops import (flat, ipc, legendre, mask, ramp,
                                             refsub, saturation, sky)
from romanimpreprocess_tpu_torch.utils import bitutils

torch.set_num_threads(1)

READ_PATTERN = [[0], [1, 2], [3, 4, 5], [6, 7, 8, 9, 10], [11, 12], [13]]
T = torch.from_numpy


def _dq(u32):
    return T(np.ascontiguousarray(u32, np.uint32).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max())


# --------------------------------------------------------------------------
# refsub: numpy medians (mean of the middle pair for even counts)
# --------------------------------------------------------------------------

def test_median_even_count_is_numpys():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert refsub.median(x).item() == 2.5  # torch.median gives 2.0
    assert torch.median(x).item() == 2.0


@pytest.mark.parametrize("nside", [64, 66])
def test_ref_subtraction_row_matches_jax(nside):
    # 66: the active width 58 and the border count 8 are both even, so
    # every median averages a middle pair
    rng = np.random.RandomState(nside)
    img = rng.normal(1000, 30, (nside, nside)).astype(np.float32)
    img += rng.normal(0, 5, (nside, 1)).astype(np.float32)
    want = jrefsub.ref_subtraction_row(jnp.asarray(img), nside=nside, nborder=4)
    got = refsub.ref_subtraction_row(T(img), nside=nside, nborder=4)
    # medians are exact; the fitted slope's sums run in another order
    _close(got, want, 1e-6, 1e-6)


def test_ref_subtraction_row_batched_and_amp33():
    rng = np.random.RandomState(3)
    nside, cw = 64, 8
    cube = rng.normal(1000, 30, (3, nside, nside + cw)).astype(np.float32)
    got = refsub.ref_subtraction_row(T(cube), nside=nside, nborder=4,
                                     channelwidth=cw, use_ref_channel=True,
                                     slope=0.7)
    for g in range(3):
        want = jrefsub.ref_subtraction_row(
            jnp.asarray(cube[g]), nside=nside, nborder=4, channelwidth=cw,
            use_ref_channel=True, slope=0.7)
        _close(got[g], want, 1e-6, 1e-6)


@pytest.mark.parametrize("cw", [8, 16])
def test_ref_subtraction_channel_matches_jax(cw):
    rng = np.random.RandomState(cw)
    nside = 64
    img = rng.normal(1000, 30, (2, nside, nside)).astype(np.float32)
    got = refsub.ref_subtraction_channel(T(img), nside=nside, nborder=4,
                                         channelwidth=cw)
    for g in range(2):
        want = jrefsub.ref_subtraction_channel(
            jnp.asarray(img[g]), nside=nside, nborder=4, channelwidth=cw)
        _close(got[g], want, 1e-6, 1e-6)


# --------------------------------------------------------------------------
# saturation (box dilation = max_pool2d with SAME padding)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backup", [1, 2])
def test_flag_saturation_matches_jax(backup):
    rng = np.random.RandomState(10 + backup)
    G, n = 6, 32
    data = rng.uniform(-50, 1000, (G, n, n)).astype(np.float32)
    data = np.cumsum(np.abs(data), axis=0).astype(np.float32) - 100
    thr = rng.uniform(1500, 4000, (n, n)).astype(np.float32)
    sat_dq = ((rng.rand(n, n) < 0.05) * pixel.NO_SAT_CHECK).astype(np.uint32)
    rdq = np.zeros((G, n, n), np.uint32)
    rdq[0] |= 1
    pdq = ((rng.rand(n, n) < 0.1) * pixel.REFERENCE_PIXEL).astype(np.uint32)
    want = jsaturation.flag_saturation(
        jnp.asarray(data), jnp.asarray(rdq), jnp.asarray(pdq),
        jnp.asarray(thr), jnp.asarray(sat_dq), backup=backup)
    got = saturation.flag_saturation(T(data), _dq(rdq), _dq(pdq), T(thr),
                                     _dq(sat_dq), backup=backup)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u32(g), np.asarray(w))
    assert (np.asarray(want[0]) & 2).any()


# --------------------------------------------------------------------------
# legendre, ipc
# --------------------------------------------------------------------------

def test_legendre_eval_matches_jax():
    rng = np.random.RandomState(4)
    z = rng.uniform(-1.5, 1.5, (5, 17)).astype(np.float32)
    c = rng.normal(0, 1, (5, 5, 17)).astype(np.float32)
    pw, fw = jlegendre.legendre_eval(jnp.asarray(z), jnp.asarray(c))
    pg, fg = legendre.legendre_eval(T(z), T(c))
    np.testing.assert_array_equal(fg.numpy(), np.asarray(fw))
    _close(pg, pw, 1e-6, 1e-6)  # same steps; XLA may fuse them
    u = np.linspace(-1, 1, 9)
    np.testing.assert_allclose(legendre.legendre_basis_1d(3, T(u)).numpy(),
                               np.asarray(jlegendre.legendre_basis_1d(3, u)),
                               rtol=1e-6)


def test_ipc_rev_and_correct_cube_match_jax():
    rng = np.random.RandomState(5)
    na, nb = 40, 4
    cube = rng.uniform(0, 1000, (3, na + 2 * nb, na + 2 * nb)).astype(np.float32)
    K = rng.uniform(0, 0.02, (3, 3, na, na)).astype(np.float32)
    K[1, 1] = 1 - K.sum(axis=(0, 1)) + K[1, 1]
    g = rng.uniform(1.4, 1.6, (na, na)).astype(np.float32)
    want = np.asarray(jipc.correct_cube(jnp.asarray(cube), jnp.asarray(K),
                                        gain=jnp.asarray(g)))
    got = ipc.correct_cube(T(cube), T(K), gain=T(g)).numpy()
    np.testing.assert_array_equal(got[:, :nb], cube[:, :nb])
    _close(got, want, 1e-6, 1e-6)  # same 9-term sums in the same order
    fw = np.asarray(jipc.ipc_fwd(jnp.asarray(cube[0, nb:-nb, nb:-nb]),
                                 jnp.asarray(K)))
    _close(ipc.ipc_fwd(T(cube[0, nb:-nb, nb:-nb]), T(K)), fw, 1e-6, 1e-6)


# --------------------------------------------------------------------------
# ramp
# --------------------------------------------------------------------------

@pytest.mark.parametrize("exclude_first", [True, False])
def test_build_plan_identical(exclude_first):
    meta = jramp.ma_table_meta(READ_PATTERN, 3.04)
    assert ramp.ma_table_meta(READ_PATTERN, 3.04).keys() == meta.keys()
    pw = jramp.build_plan(meta, 0.005, exclude_first, {"SthreshA": 6.0})
    pg = ramp.build_plan(ramp.ma_table_meta(READ_PATTERN, 3.04), 0.005,
                         exclude_first, {"SthreshA": 6.0})
    for name, w in pw._asdict().items():
        gv = getattr(pg, name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(gv, w, err_msg=name)
        else:
            assert gv == w, name


def _ramp_case(seed, n=48, exclude_first=True):
    rng = np.random.RandomState(seed)
    meta = jramp.ma_table_meta(READ_PATTERN, 3.04)
    plan = jramp.build_plan(meta, 0.005, exclude_first)
    G = len(READ_PATTERN)
    rate = rng.uniform(0.5, 50, (n, n))
    t = meta["tbar"]
    data = (1000 + rate[None] * t[:, None, None]
            + rng.normal(0, 6, (G, n, n))).astype(np.float32)
    data[3:, 5:9, 5:9] += 400.0  # jumps after group 2
    rdq = np.zeros((G, n, n), np.uint32)
    if exclude_first:
        rdq[0] |= 1
    rdq[4:, 20, 20] |= 2  # saturated from group 4 (truncated fit)
    rdq[2:, 30, 30] |= 2  # saturated early
    rdq[1:, 31, 31] |= 2  # saturated by group 1: DO_NOT_USE
    pdq = np.zeros((n, n), np.uint32)
    pdq[0, :] |= np.uint32(pixel.REFERENCE_PIXEL)
    gain = rng.uniform(1.4, 1.6, (n, n)).astype(np.float32)
    rs = rng.uniform(6, 11, (n, n)).astype(np.float32)
    return plan, data, rdq, pdq, gain, rs


@pytest.mark.parametrize("exclude_first", [True, False])
def test_ramp_fit_matches_jax(exclude_first):
    plan, data, rdq, pdq, gain, rs = _ramp_case(6, exclude_first=exclude_first)
    want = jramp.ramp_fit(jnp.asarray(data), jnp.asarray(rdq), jnp.asarray(pdq),
                          plan, jnp.asarray(gain), jnp.asarray(rs))
    got = ramp.ramp_fit(T(data), _dq(rdq), _dq(pdq), plan, T(gain), T(rs))
    # slopes: the same 6-term weighted sums, rtol 1e-5 of the value and
    # 1e-5 of the largest (another summation order)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 1e-5, 1e-5)
    rdq_w, pdq_w = np.asarray(want[3]), np.asarray(want[4])
    assert (rdq_w & 4).any(), "the case must flag jumps"
    # JUMP_DET may flip for a pixel within an ulp of its threshold
    # (rsqrt): at most 1e-4 of pixels; every other bit is exact
    for g, w in ((_u32(got[3]), rdq_w), (_u32(got[4]), pdq_w)):
        diff = g ^ w
        assert not (diff & ~np.uint32(4)).any()
        assert (diff != 0).mean() <= 1e-4


def test_first_saturated_group_and_interior():
    rdq = np.zeros((5, 3, 3), np.uint32)
    rdq[2:, 1, 1] = 2
    rdq[0, 0, 0] = 2 | np.uint32(2**31)
    fs = ramp.first_saturated_group(_dq(rdq)).numpy()
    np.testing.assert_array_equal(fs, np.asarray(
        jramp.first_saturated_group(jnp.asarray(rdq))))
    assert fs[1, 1] == 2 and fs[0, 0] == 0 and fs[2, 2] == 5
    m = ramp.interior_mask(6, 6, 0)
    assert bool(m.all())
    np.testing.assert_array_equal(ramp.interior_mask(8, 8, 2).numpy(),
                                  np.asarray(jramp.interior_mask(8, 8, 2)))


# --------------------------------------------------------------------------
# mask, sky
# --------------------------------------------------------------------------

def test_pixelmask1_matches_jax():
    rng = np.random.RandomState(8)
    bits = rng.randint(0, 32, (64, 64))
    dq = np.where(rng.rand(64, 64) < 0.03, np.uint32(1) << bits.astype(np.uint32),
                  0).astype(np.uint32)
    want = np.asarray(jmask.PixelMask1.build(jnp.asarray(dq)))
    np.testing.assert_array_equal(mask.PixelMask1.build(dq).numpy(), want)
    np.testing.assert_array_equal(mask.PixelMask1.build(_dq(dq)).numpy(), want)


def test_binkxk_bit_identical():
    rng = np.random.RandomState(9)
    a = rng.normal(0, 10, (37, 41)).astype(np.float32)
    a[3, 5] = np.nan
    want = np.asarray(jsky.binkxk(jnp.asarray(a), 4))
    got = sky.binkxk(T(a), 4).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_smooth_mode_matches_jax(seed):
    rng = np.random.RandomState(seed)
    a = rng.normal(3.0, 0.5, (30, 30)).astype(np.float32)
    a[rng.rand(30, 30) < 0.1] = np.nan
    a[:2] += 40.0  # outliers
    mw, sw = jsky.smooth_mode(jnp.asarray(a))
    mg, sg = sky.smooth_mode(T(a))
    # nanquantile == nanpercentile (linear); the kernel-density sums run
    # in another order: rtol 1e-5
    np.testing.assert_allclose(sg.item(), float(sw), rtol=1e-5)
    np.testing.assert_allclose(mg.item(), float(mw), rtol=1e-5)


@pytest.mark.parametrize("order,shape", [(2, (120, 120)), (1, (100, 92)),
                                         (3, (64, 70))])
def test_medfit_matches_jax(order, shape):
    rng = np.random.RandomState(order)
    ny, nx = shape
    yy, xx = np.mgrid[0:ny, 0:nx] / max(ny, nx)
    a = (2.0 + xx - 0.5 * yy**2 + rng.normal(0, 0.05, shape)).astype(np.float32)
    a[rng.rand(*shape) < 0.05] = np.nan
    cw, mw = jsky.medfit(jnp.asarray(a), order=order)
    cg, mg = sky.medfit(T(a), order=order)
    # block medians exact; the small solve and products in full fp32
    # but another order: rtol 1e-4 on coefficients and the model
    _close(cg, cw, 1e-4, 1e-5)
    _close(mg, mw, 1e-4, 1e-5)
    np.testing.assert_allclose(
        sky.sky_model_from_coefs(cg.numpy(), ny, nx, order),
        jsky.sky_model_from_coefs(np.asarray(cw), ny, nx, order),
        rtol=1e-4, atol=1e-5)


def test_block_nanmedian_plain_matches_jax_bisection():
    rng = np.random.RandomState(12)
    a = (rng.randn(90, 77) * 50).astype(np.float32)
    a[rng.rand(90, 77) < 0.3] = np.nan
    want = np.asarray(jsky.block_nanmedian(jnp.asarray(a), 8))
    got = sky.block_nanmedian(T(a), 8).numpy()
    assert ((got == want) | (np.isnan(got) & np.isnan(want))).all()


# --------------------------------------------------------------------------
# flat, bitutils
# --------------------------------------------------------------------------

@pytest.mark.parametrize("deconvolve,with_pdq", [(True, True), (True, False),
                                                 (False, True)])
def test_get_flat_matches_jax(deconvolve, with_pdq):
    rng = np.random.RandomState(12)
    n, nb = 48, 4
    na = n - 2 * nb
    f = rng.uniform(0.8, 1.2, (n, n)).astype(np.float32)
    f[10, 10], f[11, 30], f[0, 0] = 0.01, 25.0, 50.0  # out of range; border ignored
    gain = rng.uniform(1.4, 1.6, (n, n)).astype(np.float32)
    gain[20, 20] = 0.05  # NO_GAIN_VALUE, clipped to 0.1
    K = rng.uniform(0, 0.02, (3, 3, na, na)).astype(np.float32)
    K[1, 1] = 1 - K.sum(axis=(0, 1)) + K[1, 1]
    pdq = (rng.rand(n, n) < 0.05).astype(np.uint32) * np.uint32(pixel.DEAD)
    want, want_dq = jflat.get_flat(
        jnp.asarray(f), jnp.asarray(gain), jnp.asarray(K), nborder=nb,
        pdq=jnp.asarray(pdq) if with_pdq else None, ipc_deconvolve=deconvolve)
    got, got_dq = flat.get_flat(
        T(f), T(gain), T(K), nborder=nb, pdq=_dq(pdq) if with_pdq else None,
        ipc_deconvolve=deconvolve)
    # the IPC inverse's nine products are summed in another order
    _close(got, want, 1e-6, 1e-6)
    assert got[0, 0] == 1.0 and got.dtype == torch.float32
    if with_pdq:
        np.testing.assert_array_equal(_u32(got_dq), np.asarray(want_dq))
        assert _u32(got_dq)[10, 10] & pixel.NO_FLAT_FIELD
        assert bool(_u32(got_dq)[20, 20] & pixel.NO_GAIN_VALUE) == deconvolve
    else:
        assert got_dq is None and want_dq is None


def test_convert_uint32_to_bits_matches_reference():
    rng = np.random.RandomState(5)
    arr = rng.randint(0, 2**32, (7, 9), dtype=np.uint64).astype(np.uint32)
    got = bitutils.convert_uint32_to_bits(arr)
    np.testing.assert_array_equal(got, jbitutils.convert_uint32_to_bits(arr))
    assert got.shape == (32, 7, 9) and got.dtype == np.uint8
    back = (got.astype(np.uint64) << np.arange(32, dtype=np.uint64)[:, None, None]).sum(0)
    np.testing.assert_array_equal(back.astype(np.uint32), arr)
