"""The redesigned kernels' host-side logic, on the CPU.

The CUDA kernels of ``csrc/blockmed.cu`` and ``csrc/pink.cu`` run only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  What can be
held here:

- the block nanmedian's selection by digits.  :func:`select_by_digits`
  is a plain-torch model of the cluster kernel's arithmetic, kept in
  this file: uint32 total-order keys, NaN above every value, the block
  cut into the shares of a cluster's CTAs whose integer counts are
  added, eight rounds of 4-bit digits for the lower middle value (the
  valid values counted in the first), and the upper middle value as the
  same key or the next one in order, from the last round's counts and a
  minimum taken in that round.
  It is held bit for bit against the reference's rule (the two middle
  valid values averaged as ``0.5 * (lo + hi)`` in float32; this is
  ``np.nanmedian`` wherever ``lo + hi`` does not overflow), against the
  plain twin ``sky.block_nanmedian`` and against the JAX package's
  Pallas kernel ``median_pallas.block_nanmedian_fused`` in interpret
  mode, on seeded numpy inputs and on the edge values (signed zeros,
  infinities, duplicates at the median, even and odd counts, one valid
  value, no valid value, middle values whose sum overflows);
- the wrapper's dispatch on the block's size (``median_cuda.plan``) and
  on the transform's length (``pink_cuda.uses_wgmma``);
- the pink kernel's constants as laid out for ``wgmma``
  (``pink_cuda.kernel_constants``): exactly the matrices of
  ``pink.dft_matrices``, so the cast points do not move.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from romanimpreprocess_tpu.ops import median_pallas
from romanimpreprocess_tpu_torch.ops import median_cuda, pink, pink_cuda, sky

torch.set_num_threads(1)

NAN_KEY = 0xFFFFFFFF


def order_keys(x):
    """uint32 keys (held in int64) that sort like the float total order,
    NaN mapped above everything: the kernel's ``order_key``."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (bits & 0x80000000) != 0
    keys = torch.where(neg, ~bits & 0xFFFFFFFF, bits + 0x80000000)
    return torch.where(torch.isnan(x), torch.full_like(keys, NAN_KEY), keys)


def key_values(keys):
    """The floats of uint32 keys (held in int64): ``key_value``."""
    bits = torch.where(keys >= 0x80000000, keys - 0x80000000, ~keys & 0xFFFFFFFF)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def select_by_digits(block, ctas=8):
    """Median of one block (1-D float32 tensor) as the cluster kernel
    finds it.  Returns (median, rounds), rounds counting the cluster-wide
    exchanges (barriers) it took: eight, or one for a block with no
    valid value."""
    shares = [order_keys(s) for s in torch.chunk(block, ctas)]
    rounds = 0
    cnt = k = prefix = n_equal = d = 0
    above = NAN_KEY
    total = None
    for r in range(8):
        shift = 28 - 4 * r
        mask = 0 if r == 0 else (0xFFFFFFFF << (shift + 4)) & 0xFFFFFFFF
        total = torch.zeros(16, dtype=torch.int64)
        for keys in shares:  # each CTA's counts, combined across the cluster
            match = ((keys ^ prefix) & mask) == 0
            total += torch.bincount((keys[match] >> shift) & 15, minlength=16)
            if r == 7:  # the smallest key above the 16 that share the prefix
                up = keys[(keys >> 4) > (prefix >> 4)]
                above = min(above, int(up.min())) if up.numel() else above
        rounds += 1
        if r == 0:  # the valid values are counted while the block is loaded
            cnt = sum(int((keys != NAN_KEY).sum()) for keys in shares)
            if cnt == 0:
                return float("nan"), rounds
            k = (cnt - 1) // 2
        below, d = 0, 0
        for i in range(16):
            n = int(total[i])
            if below + n <= k:
                below, d = below + n, i + 1
            else:
                break
        assert d <= 15
        k -= below
        n_equal = int(total[d])
        prefix |= d << shift
    v_lo = v_hi = prefix
    if cnt % 2 == 0 and k + 1 >= n_equal:
        v_hi = above
        for i in range(15, d, -1):
            if int(total[i]) > 0:
                v_hi = (prefix & ~15) | i
    lo, hi = key_values(torch.tensor([v_lo, v_hi]))
    return (0.5 * (lo + hi)).item(), rounds


def _model(arr, N, ctas=8):
    ky, kx, py, px = sky.block_geometry(*arr.shape, N)
    out = np.empty((N, N), np.float32)
    t = torch.from_numpy(arr)
    for by in range(N):
        for bx in range(N):
            blk = t[py + by * ky : py + (by + 1) * ky, px + bx * kx : px + (bx + 1) * kx]
            out[by, bx], _ = select_by_digits(blk.reshape(-1), ctas)
    return out


def _oracle(arr, N):
    ky, kx, py, px = sky.block_geometry(*arr.shape, N)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.nanmedian(arr[py : py + N * ky, px : px + N * kx]
                            .reshape(N, ky, N, kx), axis=(1, 3)).astype(np.float32)


def _same(a, b):
    return bool(((a == b) | (np.isnan(a) & np.isnan(b))).all())


def _reference_median(blk):
    """(median, overflowed) of a 1-D float32 block by the reference's
    rule: the two middle valid values of ``np.sort``, averaged as
    ``0.5 * (lo + hi)`` in float32 (the JAX kernel's, the twin's and the
    CUDA kernel's formula).  ``overflowed``: ``lo + hi`` overflows two
    finite values to inf, which ``np.nanmedian`` does not for an odd
    count (it takes the middle value itself)."""
    v = np.sort(blk[~np.isnan(blk)])
    if v.size == 0:
        return np.float32(np.nan), False
    lo, hi = v[(v.size - 1) // 2], v[v.size // 2]
    with np.errstate(all="ignore"):
        total = lo + hi
    return np.float32(0.5) * total, bool(np.isfinite([lo, hi]).all() and np.isinf(total))


def _check_median(got, blk):
    """``got`` is the reference's rule's value, and ``np.nanmedian``'s
    wherever ``lo + hi`` does not overflow."""
    want, overflowed = _reference_median(blk)
    assert _same(np.float32(got), want), (blk, got, want)
    if not overflowed:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with np.errstate(all="ignore"):
                assert _same(np.float32(got), np.float32(np.nanmedian(blk))), (blk, got)
    return overflowed


def test_order_keys_sort_like_floats():
    x = torch.tensor([float("-inf"), -3.5, -1e-40, -0.0, 0.0, 1e-40, 2.0,
                      float("inf"), float("nan"), -float("nan")])
    keys = order_keys(x)
    assert (keys[1:8] > keys[:7]).all()                # strictly increasing
    assert keys[8] == keys[9] == NAN_KEY and keys[7] < NAN_KEY
    back = key_values(keys[:8])
    assert torch.equal(back.view(torch.int32), x[:8].view(torch.int32))


@pytest.mark.parametrize("ny,nx,N,ctas", [(64, 64, 8, 1), (72, 68, 8, 2),
                                          (128, 120, 4, 8), (130, 125, 8, 4)])
def test_digit_selection_matches_pallas_numpy_and_twin(ny, nx, N, ctas):
    rng = np.random.RandomState(ny + nx)
    arr = (rng.randn(ny, nx) * 100).astype(np.float32)
    arr[rng.rand(ny, nx) < 0.2] = np.nan
    ky, kx, py, px = sky.block_geometry(ny, nx, N)
    arr[py : py + ky, px : px + kx] = np.nan  # one all-NaN block
    got = _model(arr, N, ctas)
    assert np.isnan(got[0, 0])
    assert _same(got, _oracle(arr, N))
    assert _same(got, sky.block_nanmedian(torch.from_numpy(arr), N).numpy())
    want = np.asarray(median_pallas.block_nanmedian_fused(
        jnp.asarray(arr), N, interpret=True))
    assert _same(got, want)


EDGE_BLOCKS = {
    "odd_count": [3.0, 1.0, 2.0],
    "even_count": [1.0, 2.0, 3.0, 4.0],
    "duplicates_at_median": [5.0, 1.0, 2.0, 2.0, 2.0, 2.0, 9.0, 0.5],
    "duplicate_then_larger": [1.0, 2.0, 2.0, 7.0],
    "signed_zeros": [-0.0, 0.0, -0.0, 0.0],
    "zeros_straddle": [-1.0, -0.0, 0.0, 1.0],
    "infinities": [float("-inf"), float("-inf"), float("inf"), float("inf")],
    "inf_and_finite": [float("-inf"), 1.0, 2.0, float("inf")],
    "all_inf": [float("inf")] * 5,
    "one_valid": [float("nan"), -0.0, float("nan"), float("nan")],
    "two_valid": [float("nan"), 4.0, float("nan"), -4.5],
    "all_nan": [float("nan")] * 6,
    "denormals": [1e-45, -1e-45, 3e-45, 0.0],
    "nan_with_sign": [-float("nan"), 1.0, float("nan"), 3.0],
    "adjacent_floats": [1.0, float(np.nextafter(np.float32(1), np.float32(2))), 1.0,
                        float(np.nextafter(np.float32(1), np.float32(2)))],
    "huge_and_tiny": [3.4e38, -3.4e38, 1e-38, -1e-38, 0.0],
    # lo + hi overflows: 0.5 * (lo + hi) is inf in every implementation
    "overflow_middle": [1.7014118e38],
    "overflow_middle_of_three": [3e38, 3.1e38, 1.0],
}


@pytest.mark.parametrize("ctas", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(EDGE_BLOCKS))
def test_digit_selection_edge_values(name, ctas):
    blk = np.array(EDGE_BLOCKS[name], np.float32)
    got, rounds = select_by_digits(torch.from_numpy(blk), ctas)
    overflowed = _check_median(got, blk)
    assert overflowed == name.startswith("overflow") and (not overflowed or np.isinf(got))
    # the twin and the JAX kernel on the same block (as one 1 x n frame)
    twin = sky.block_nanmedian(torch.from_numpy(blk[None]), 1).numpy()[0, 0]
    assert _same(np.float32(got), twin)
    jx = np.asarray(median_pallas.block_nanmedian_fused(
        jnp.asarray(blk[None]), 1, interpret=True))[0, 0]
    assert _same(np.float32(got), jx)
    assert rounds == (8 if (~np.isnan(blk)).any() else 1)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(st.one_of(
    st.floats(width=32, allow_nan=True, allow_infinity=True),
    st.sampled_from([0.0, -0.0, 1.0, 1.0, -1.0, float("inf"), float("-inf")])),
    min_size=1, max_size=40), st.integers(1, 8))
@example(values=[1.7014118346046923e+38], ctas=1)
def test_digit_selection_hypothesis(values, ctas):
    blk = np.array(values, np.float32)
    got, _ = select_by_digits(torch.from_numpy(blk), ctas)
    # inf + -inf at the middle is NaN in both
    _check_median(got, blk)


@pytest.mark.parametrize("shape,N,want", [
    ((4088, 4088), 8, ("cluster", 8, 64)),     # the main path: 8 x 130.8 KB
    ((130, 125), 8, ("cluster", 1, 16)),       # tiny blocks: one CTA
    ((803, 1001), 4, ("cluster", 2, 100)),
    ((301, 260), 1, ("cluster", 4, 76)),
    ((640, 640), 1, ("cluster", 8, 80)),       # 409,600 values: the largest cluster
    ((700, 701), 1, ("stream", 0, 0)),         # too large for 8 CTAs
    ((4088, 4088), 1, ("stream", 0, 0)),
    ((256, 256), 128, ("cluster", 1, 2)),
])
def test_median_plan_branches(shape, N, want):
    got = median_cuda.plan(*shape, N)
    assert got == want
    if got[0] == "cluster":
        ky, kx, _, _ = sky.block_geometry(*shape, N)
        assert got[1] in (1, 2, 4, 8) and got[1] * got[2] >= ky
        assert got[2] * kx <= median_cuda.KEYS_MAX
        # a thread of the 512 scans at most 255 keys a round (8-bit fields)
        assert -(-got[2] * kx // 512) <= 255
        assert got[2] * kx * 4 <= 200 * 1024


def test_median_bytes_bound_unchanged():
    assert median_cuda.bytes_moved(4088, 4088, 8) == 4 * (4088 * 4088 + 64)


@pytest.mark.parametrize("length,want", [(1 << 14, False), (1 << 15, False),
                                         (1 << 16, True), (1 << 17, True),
                                         (1 << 20, True), (1 << 21, True)])
def test_pink_path_by_length(length, want):
    n1, n2 = pink.split_length(length)
    assert pink_cuda.uses_wgmma(n1, n2) == want
    assert n1 % pink_cuda.MIN_FACTOR == 0 and n2 % pink_cuda.MIN_FACTOR == 0


@pytest.mark.parametrize("n1,n2", [(256, 256), (256, 512)])
def test_pink_wgmma_constants_reproduce_dft_matrices(n1, n2):
    e1c, e1s, e2c, e2s, wc, ws = pink.dft_matrices(n1, n2, n2 // 2)
    c = pink_cuda.kernel_constants(n1, n2, torch.device("cpu"))
    assert set(c) == {"amp", "wc", "ws", "b1t", "a2", "msum"}
    m2 = n2 // 2
    b1t, a2 = c["b1t"], c["a2"]
    assert b1t.shape == (2 * n1, 2 * n1) and b1t.dtype == torch.bfloat16
    assert a2.shape == (n2, 2 * n2) and a2.dtype == torch.bfloat16
    assert b1t.is_contiguous() and a2.is_contiguous()
    # stage 1, K-major: row = output m1 (Re block, then Im), column = k
    # over blocks of 32 Re k1 then the same 32 Im k1:
    #   ar = cr e1c + ci e1s,  ai = ci e1c - cr e1s
    kb = pink_cuda.K1_BLOCK
    blocks = b1t.reshape(2 * n1, n1 // kb, 2, kb)
    re_k, im_k = blocks[:, :, 0].reshape(2 * n1, n1), blocks[:, :, 1].reshape(2 * n1, n1)
    assert torch.equal(re_k[:n1], e1c.T) and torch.equal(im_k[:n1], e1s.T)
    assert torch.equal(re_k[n1:], -e1s.T) and torch.equal(im_k[n1:], e1c.T)
    # stage 2, K-major: row = output m2 (Re block, then Im), column = k
    # over [Re k2 | Im k2]:  xr = e2c^T br + e2s^T bi,  xi = e2c^T bi - e2s^T br
    assert torch.equal(a2[:m2, :n2], e2c.T) and torch.equal(a2[:m2, n2:], e2s.T)
    assert torch.equal(a2[m2:, :n2], -e2s.T) and torch.equal(a2[m2:, n2:], e2c.T)
    assert torch.equal(c["wc"], wc) and torch.equal(c["ws"], ws)
    # the matrices of stage 2 summed over m2, rounded once from float64
    msum = c["msum"]
    assert msum.shape == (2, n2) and msum.dtype == torch.float32
    assert torch.equal(msum[0], e2c.double().sum(dim=1).float())
    assert torch.equal(msum[1], e2s.double().sum(dim=1).float())
    assert torch.equal(c["amp"].reshape(-1), pink.amplitude(n1 * n2))


def test_pink_wgmma_constants_give_the_twin_transform():
    """The products the wgmma kernels form, written with the re-laid
    constants in float32, equal the twin's stages: the layout changes
    nothing but where the numbers lie."""
    n1 = n2 = 256
    rng = np.random.RandomState(3)
    white = torch.from_numpy(rng.randn(1, 2, n1 * n2).astype(np.float32)).to(torch.bfloat16)
    c = pink_cuda.kernel_constants(n1, n2, torch.device("cpu"))
    shaped = (white * c["amp"].reshape(-1)).float()               # bf16 product, rounded
    a_op = shaped.reshape(2 * n1, n2).T                           # (k2, [Re k1 | Im k1])
    a_op = pink_cuda.block_k1(a_op, n1)                           # the kernel's K order
    acc = a_op @ c["b1t"].float().T                               # (k2, [Re m1 | Im m1])
    ar, ai = acc[:, :n1], acc[:, n1:]
    br = (ar * c["wc"] + ai * c["ws"]).to(torch.bfloat16).float()
    bi = (ai * c["wc"] - ar * c["ws"]).to(torch.bfloat16).float()
    x = c["a2"].float() @ torch.cat([br, bi], dim=0)              # ([Re m2; Im m2], m1)
    got = x.reshape(2, -1)
    # the frames' sums from the intermediate, as stage 1 forms them
    C, S = c["msum"].double()
    sr, si = br.double().sum(dim=1), bi.double().sum(dim=1)
    sums = torch.stack([(C * sr + S * si).sum(), (C * si - S * sr).sum()])
    assert torch.allclose(sums, got.double().sum(dim=-1), rtol=0,
                          atol=1e-6 * got.abs().sum(dim=-1).max().item())
    got = got - (sums / got.shape[-1]).float()[:, None]
    want = pink.pink_from_white_plain(white)
    s = want.std()
    d = (got - want).abs()
    # same cast points, another order of the f32 sums
    assert d.std() < 1e-4 * s and d.max() < 3e-3 * s, (d.std() / s, d.max() / s)


def test_pink_mma_constants_keep_their_layout_below_the_wgmma_sizes():
    c = pink_cuda.kernel_constants(128, 128, torch.device("cpu"))
    assert set(c) == {"amp", "wc", "ws", "b1r", "b1i", "a2r", "a2i"}
    assert c["b1r"].shape == (256, 128) and c["a2i"].shape == (64, 256)
