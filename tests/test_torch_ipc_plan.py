"""The slab IPC kernel's partition and sum schedules, on the CPU.

``ipc_slab.plan`` cuts a (ngrp, na, na) cube into warp strips (64
columns, two a lane, 60 written), row segments (4 warm-up rows each)
and group chunks (at most 8 in registers).  :func:`kernel_model` repeats the kernel of
``csrc/ipc_slab.cu`` warp by warp in plain torch: the same loads (+0
outside what it reads, gain 1), the upward row walk with its partial
tap sums, the exchange of products between neighbouring columns (the
lane shuffles; the window's edge columns take any value, as no output
reads them), the stores of the 60 inner columns.  Every step is one float32
operation, as the kernel's ``_rn`` intrinsics are, so the model must
equal its order's twin bit for bit and write every pixel exactly once:
``ipc_rev2_plain`` in the slab order, ``ipc_cuda.ipc_rev2_frame_plain``
in the Neumann order, which reads the frame's border around the active
region, forms row r + 1's taps 0..2 again after row r's centre, forms
o1 one row behind, and writes row r + 1 from the held o1 and y.
Against the JAX package's ``ipc_rev2_cube_stream`` (interpret mode) the
gate is 1e-6 of the largest value, as in ``test_torch_kernels.py``:
XLA's CPU backend contracts each multiply-add of the tap sums into one
fused multiply-add (checked below), which rounds once where the kernel
and the twin round twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romanimpreprocess_tpu.ops import ipc_pallas
from romanimpreprocess_tpu_torch.ops import ipc_cuda, ipc_slab
from romanimpreprocess_tpu_torch.utils import time_frame

torch.set_num_threads(1)


def _shfl_down(v):
    """Each column takes the next one's value; the last keeps its own."""
    return torch.cat([v[..., 1:], v[..., -1:]], dim=-1)


def _shfl_up(v):
    return torch.cat([v[..., :1], v[..., :-1]], dim=-1)


def _to_neighbours(v):
    """``v`` (..., 9, strips, columns): taps t % 3 == 0 from the column
    to the right, t % 3 == 2 from the column to the left."""
    v = v.clone()
    for t in (0, 3, 6):
        v[..., t, :, :] = _shfl_down(v[..., t, :, :])
        v[..., t + 2, :, :] = _shfl_up(v[..., t + 2, :, :])
    return v


def _taps3(acc, v, t0):
    return ((acc + v[:, t0]) + v[:, t0 + 1]) + v[:, t0 + 2]


def _centre_to5(v):
    """The Neumann order's sum through tap 5: centre, taps 0, 1, 2, 3, 5."""
    return (_taps3(v[:, 4], v, 0) + v[:, 3]) + v[:, 5]


def kernel_model(cube, planes, gain=None, resident=ipc_slab.RESIDENT_H100,
                 order=ipc_slab.SLAB, nb=0):
    """The kernel's output on the active region ``[nb, n - nb)^2`` of a
    (ngrp, n, n) cube, and how often each pixel was written.  ``planes``
    (9, n, n) and ``gain`` (n, n) cover the same frame.  The slab order
    reads the active region; the Neumann order also ``min(nb, 2)`` rows
    and columns of the border around it."""
    ngrp, n, _ = cube.shape
    na = n - 2 * nb
    neumann = order == ipc_slab.NEUMANN
    ext = min(nb, ipc_slab.NEUMANN_EXT) if neumann else 0
    p = ipc_slab.plan(na, ngrp, resident)
    out = torch.zeros((ngrp, na, na))
    writes = torch.zeros(out.shape, dtype=torch.int32)
    x = torch.arange(ipc_slab.WIDTH)
    c = ipc_slab.STRIP * torch.arange(-(-na // ipc_slab.STRIP))[:, None] - 2 + x
    cin = (c >= -ext) & (c < na + ext)
    emit = (x >= 2) & (x < ipc_slab.WIDTH - 2) & (c < na)
    cc = torch.where(cin, c, 0) + nb
    GC = p.chunk
    for ch in range(p.nchunks):
        g0 = ch * GC
        ng = min(GC, ngrp - g0)
        for sg in range(p.nseg):
            rs = sg * p.seg
            re = min(rs + p.seg, na)

            def load(r):
                inn = cin & (-ext <= r < na + ext)
                rr = min(max(r, -ext), na + ext - 1) + nb
                k = torch.where(inn, planes[:, rr, cc], 0.0)
                g = torch.ones(cc.shape) if gain is None else gain[rr, cc]
                g = torch.where(inn, g, 1.0)
                d = torch.zeros((GC,) + cc.shape)
                d[:ng] = torch.where(inn, cube[g0 : g0 + ng, rr, cc], 0.0)
                return k, g, d

            z = torch.zeros((GC,) + cc.shape)
            an, am, bn, bm, y1, u, y2, o1p = (z.clone() for _ in range(8))
            kp = kq = torch.zeros((9,) + cc.shape)
            g1 = g2 = torch.ones(cc.shape)
            nxt = load(re + 1)
            for s in range(re + 1, rs - 3, -1):
                kc, gs, dn = nxt
                y = dn * gs
                if s > rs - 2:
                    nxt = load(s - 1)
                arow = cin & (-ext <= s + 1 < na + ext)
                if neumann:
                    # row s + 1's taps 0..2 formed again, row s's 3..8
                    v = _to_neighbours(torch.cat(
                        [y1[:, None] * kp[None, :3], y[:, None] * kc[None, 3:]], 1))
                    af = _taps3(am, v, 6)
                    am = _centre_to5(v)
                    o1 = torch.where(arow, (y1 + y1) - af, 0.0)
                    # o1-row s + 2's taps 0..2 formed again, o1-row s + 1's 3..8
                    v = _to_neighbours(torch.cat(
                        [o1p[:, None] * kq[None, :3], o1[:, None] * kp[None, 3:]], 1))
                    bf = _taps3(bm, v, 6)
                    bm = _centre_to5(v)
                    res = (o1p + y2) - bf
                    o1p, y2 = o1, y1
                else:
                    v = _to_neighbours(y[:, None] * kc[None])
                    af = _taps3(am, v, 6)
                    am = _taps3(an, v, 3)
                    an = (v[:, 0] + v[:, 1]) + v[:, 2]
                    af = torch.where(arow, af, 0.0)
                    v = _to_neighbours(af[:, None] * kp[None])
                    bf = _taps3(bm, v, 6)
                    bm = _taps3(bn, v, 3)
                    bn = (v[:, 0] + v[:, 1]) + v[:, 2]
                    res = u + bf
                    u = 3.0 * y1 - 3.0 * af
                if s + 2 < re:
                    res = res / g2
                    for j in range(ng):
                        out[g0 + j, s + 2, c[emit]] = res[j][emit]
                        writes[g0 + j, s + 2, c[emit]] += 1
                y1 = y
                kq, kp, g2, g1 = kp, kc, g1, gs
    return out, writes


def _case(ngrp, na, seed, with_gain=True):
    rng = np.random.RandomState(seed)
    K = rng.uniform(0, 0.02, (3, 3, na, na)).astype(np.float32)
    K[1, 1] = 1 - K.sum(axis=(0, 1)) + K[1, 1]
    cube = rng.uniform(0, 1000, (ngrp, na, na)).astype(np.float32)
    gain = rng.uniform(1.4, 1.6, (na, na)).astype(np.float32) if with_gain else None
    return cube, K, gain


def _t(a):
    return None if a is None else torch.from_numpy(a)


# (ngrp, na, resident CTAs): one strip or less, ragged strips and
# segments, more groups than a chunk (9, 17), and a small ``resident``
# that forces several segments on a small frame
MODEL_CASES = [(1, 20, 528), (3, 67, 528), (2, 67, 4), (9, 60, 8), (17, 45, 528),
               (6, 131, 16), (2, 131, 528)]


@pytest.mark.parametrize("with_gain", [True, False])
@pytest.mark.parametrize("ngrp,na,resident", MODEL_CASES)
def test_kernel_model_is_the_twin_and_the_jax_kernel(ngrp, na, resident, with_gain):
    cube, K, gain = _case(ngrp, na, na + ngrp, with_gain)
    planes = torch.from_numpy(K.reshape(9, na, na))
    got, writes = kernel_model(_t(cube), planes, _t(gain), resident)
    p = ipc_slab.plan(na, ngrp, resident)
    assert bool((writes == 1).all()), p
    twin = ipc_slab.ipc_rev2_plain(_t(cube), planes, _t(gain))
    assert torch.equal(got, twin), p
    want = np.asarray(ipc_pallas.ipc_rev2_cube_stream(
        jnp.asarray(cube), jnp.asarray(K), None if gain is None else jnp.asarray(gain),
        th=8, interpret=True))
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_xla_cpu_contracts_multiply_add():
    """Why the JAX kernel is held to 1e-6 and not to its bits: on the
    CPU, XLA computes ``a * b + c`` as one fused multiply-add."""
    rng = np.random.RandomState(1)
    a, b, c = (rng.uniform(0, 1000, 4096).astype(np.float32) for _ in range(3))
    got = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    fused = (a.astype(np.float64) * b + c).astype(np.float32)
    np.testing.assert_array_equal(got, fused)
    assert (got != a * b + c).any()


def test_kernel_model_at_1000_on_several_segments():
    """A frame that is a multiple of neither the strip nor the segment,
    cut into several segments and chunks, against the twin."""
    cube, K, gain = _case(9, 1000, 3)
    planes = torch.from_numpy(K.reshape(9, 1000, 1000))
    assert ipc_slab.plan(1000, 9, 160)[1:5] == (63, 16, 5, 2)
    got, writes = kernel_model(_t(cube), planes, _t(gain), 160)
    assert bool((writes == 1).all())
    assert torch.equal(got, ipc_slab.ipc_rev2_plain(_t(cube), planes, _t(gain)))


def test_kernel_model_zero_outside_with_nonfinite_data():
    """Sources outside the active region read as +0 in both passes: a
    NaN or inf inside spills into the a-ring outside the region, which
    the kernel zeroes as the twin's zero fill does."""
    cube, K, gain = _case(2, 40, 11)
    cube[0, 0, 5] = np.nan
    cube[1, 39, 39] = np.inf
    cube[1, 20, 0] = -np.inf
    planes = torch.from_numpy(K.reshape(9, 40, 40))
    got, _ = kernel_model(_t(cube), planes, _t(gain))
    twin = ipc_slab.ipc_rev2_plain(_t(cube), planes, _t(gain))
    same = (got == twin) | (torch.isnan(got) & torch.isnan(twin))
    assert bool(same.all())
    assert bool(torch.isfinite(got[0, 20:, 20:]).all())


def _frame_case(ngrp, nside, nb, seed):
    """A frame with negative data, border-zeroed planes and a gain over
    the whole frame, as the core hands them to the frame inverse."""
    rng = np.random.RandomState(seed)
    na = nside - 2 * nb
    K = rng.uniform(0, 0.02, (3, 3, na, na)).astype(np.float32)
    K[1, 1] = 1 - K.sum(axis=(0, 1)) + K[1, 1]
    data = rng.uniform(-500, 1000, (ngrp, nside, nside)).astype(np.float32)
    gain = rng.uniform(1.4, 1.6, (nside, nside)).astype(np.float32)
    planes = torch.from_numpy(ipc_cuda.kernel_planes_frame(K, nside, nb))
    return torch.from_numpy(data), planes, torch.from_numpy(gain)


# (ngrp, nside, nborder, resident CTAs): one strip or less, a strip's
# edge (60 and 61 active columns), ragged strips and segments, more
# groups than a chunk (9, 17), nborder 4, 3, 2, 1 and 0, and a small
# ``resident`` that forces several segments
NEUMANN_CASES = [(1, 20, 4, 528), (3, 68, 4, 4), (2, 69, 4, 528), (9, 67, 4, 8),
                 (17, 45, 2, 528), (6, 131, 0, 16), (2, 67, 1, 528), (6, 133, 3, 16),
                 (2, 131, 4, 528)]


@pytest.mark.parametrize("ngrp,nside,nb,resident", NEUMANN_CASES)
def test_neumann_model_is_the_frame_twin(ngrp, nside, nb, resident):
    data, planes, gain = _frame_case(ngrp, nside, nb, nside + ngrp)
    got, writes = kernel_model(data, planes, gain, resident, ipc_slab.NEUMANN, nb)
    assert bool((writes == 1).all()), ipc_slab.plan(nside - 2 * nb, ngrp, resident)
    twin = ipc_cuda.ipc_rev2_frame_plain(data, planes, gain, nb)
    act = slice(nb, nside - nb)
    assert time_frame.same_bits(got, twin[:, act, act])
    # the slab order on the same frame sums otherwise
    slab, _ = kernel_model(data, planes, gain, resident, ipc_slab.SLAB, nb)
    assert not torch.equal(slab, got)


def test_neumann_model_reads_the_border_as_the_twin():
    """A NaN and infinities in the two border rows and columns next to
    the active region reach the output through their zero weights, as in
    the twin; a model that zero-fills the border instead differs."""
    nb, nside = 4, 70
    data, planes, gain = _frame_case(3, nside, nb, 5)
    na = nside - 2 * nb
    data[0, nb - 2, 30] = float("nan")       # two rows below the region
    data[1, nb + na, 61] = -float("inf")     # the row above it, at a strip edge
    data[2, 40, nb - 1] = float("nan")       # the column left of it
    data[2, 10, nb + na + 1] = float("inf")  # two columns right of it
    got, _ = kernel_model(data, planes, gain, 16, ipc_slab.NEUMANN, nb)
    twin = ipc_cuda.ipc_rev2_frame_plain(data, planes, gain, nb)
    act = slice(nb, nside - nb)
    assert time_frame.same_bits(got, twin[:, act, act])
    assert int((~torch.isfinite(got)).sum()) >= 4
    inner = data.clone()
    inner[:, :nb] = inner[:, -nb:] = inner[:, :, :nb] = inner[:, :, -nb:] = 0.0
    zero_fill, _ = kernel_model(inner, planes, gain, 16, ipc_slab.NEUMANN, nb)
    assert bool(torch.isfinite(zero_fill).all())


def test_neumann_model_at_300_on_several_segments_and_chunks():
    data, planes, gain = _frame_case(9, 300, 4, 3)
    assert ipc_slab.plan(292, 9, 40)[1:5] == (30, 10, 5, 2)
    got, writes = kernel_model(data, planes, gain, 40, ipc_slab.NEUMANN, 4)
    assert bool((writes == 1).all())
    twin = ipc_cuda.ipc_rev2_frame_plain(data, planes, gain, 4)
    assert torch.equal(got, twin[:, 4:-4, 4:-4])


@pytest.mark.parametrize("na", [1, 2, 27, 28, 29, 67, 112, 113, 131, 1000, 4088, 4096])
@pytest.mark.parametrize("ngrp", [1, 2, 5, 6, 8, 9, 16, 17, 24, 33, 49])
def test_plan_covers_the_cube(na, ngrp):
    for resident in (1, 16, ipc_slab.RESIDENT_H100, 132 * 16):
        p = ipc_slab.plan(na, ngrp, resident)
        assert p.strip == ipc_slab.STRIP
        # group chunks: at most 8, none empty, as even as they go
        assert 1 <= p.chunk <= ipc_slab.GROUP_CHUNK
        assert (p.nchunks - 1) * p.chunk < ngrp <= p.nchunks * p.chunk
        assert p.nchunks == -(-ngrp // ipc_slab.GROUP_CHUNK)
        # strips: every column written by one warp, no CTA without work
        assert p.ctas_x * ipc_slab.WARPS * p.strip >= na
        assert (p.ctas_x - 1) * ipc_slab.WARPS * p.strip < na
        # segments: every row, none empty, none shorter than MIN_SEG
        # unless the frame is
        assert (p.nseg - 1) * p.seg < na <= p.nseg * p.seg
        assert p.seg >= min(na, ipc_slab.MIN_SEG)
        assert p.grid == p.ctas_x * p.nseg * p.nchunks
        # one wave of resident CTAs, unless one segment per strip is more
        assert p.grid <= max(resident, p.ctas_x * p.nchunks)


def test_plan_at_the_main_paths_shape():
    """6 groups of 4088^2: one chunk (the planes read once), one wave,
    and the loads beyond one read of each input under 15% of the bytes
    the function must move."""
    p = ipc_slab.plan(4088, 6, ipc_slab.RESIDENT_H100)
    assert (p.chunk, p.nchunks, p.ctas_x) == (6, 1, 18)
    assert p.grid <= ipc_slab.RESIDENT_H100 and p.seg > 150
    share = ipc_slab.reread_share(4088, 6)
    assert 0.05 < share < 0.15
    # the halo columns are most of it: with no warm-up rows the share is
    # (64 / 60 - 1) x 16 / 22 of the bytes
    assert share - (64 / 60 - 1) * 16 / 22 < 0.02


def test_plan_for_the_frame_inverse():
    """The frame inverse (Neumann order) at 6 groups of 4096^2 takes the
    same partition of the 4088^2 active region; reading two border rows
    and columns around it adds under two thousandths to the loads."""
    p = ipc_slab.plan(4088, 6, ipc_slab.RESIDENT_H100)
    assert (p.chunk, p.nchunks, p.ctas_x) == (6, 1, 18)
    base = ipc_slab.reread_share(4088, 6)
    share = ipc_slab.reread_share(4088, 6, ext=ipc_slab.NEUMANN_EXT)
    assert base < share < base + 2e-3
    # small frames: every segment's warm-up rows and the edge halo inside
    # the border are read, nothing outside the frame
    assert ipc_slab.reread_share(60, 1, 1, ext=2) == pytest.approx(
        (11 * (64 * 64) - 11 * 60 * 60) / (12 * 60 * 60))


def test_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="positive"):
        ipc_slab.plan(0, 6)
    with pytest.raises(ValueError, match="positive"):
        ipc_slab.plan(100, 0)


def test_plan_constants_are_the_kernels():
    """The partition the plan and the model assume is the one
    ``csrc/ipc_slab.cu`` is compiled with."""
    import re

    src = (ipc_slab.cuda_build.CSRC / "ipc_slab.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["LANES"] * const["COLS"] == ipc_slab.WIDTH
    assert ipc_slab.WIDTH - 2 * const["HALO"] == ipc_slab.STRIP
    assert const["WARPS"] == ipc_slab.WARPS
    assert const["MAX_CHUNK"] == ipc_slab.GROUP_CHUNK
    assert const["EXT"] == ipc_slab.NEUMANN_EXT
    # the orders' numbers in the launch function
    assert "order == 0) return by_chunk(SlabOrder())" in src
    assert "order == 1) return by_chunk(NeumannOrder())" in src
    assert (ipc_slab.SLAB, ipc_slab.NEUMANN) == (0, 1)
    # the kernel asks for 3 CTAs an SM: the default resident count
    assert "__launch_bounds__(NT, 3)" in src
    assert ipc_slab.RESIDENT_H100 == 132 * 3
