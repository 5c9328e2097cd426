"""The port's linearity ops against the JAX package run op by op.

``ops/legendre.legendre_eval``, ``ops/linearity.apply_linearity`` and
``ops/linearity.apply_linearity_cube`` of the port take the same rounded
steps in the same order as the JAX functions.  Run op by op
(``jax.disable_jit()``), the JAX functions give the same values bit for
bit, and the same DQ.  (Jitted on the CPU, XLA contracts ``phi + c[L] *
term`` into a fused multiply-add, which rounds once where the op-by-op
steps round twice, so the jitted reference differs in the last bits of a
share of the values: PERF.md section 6.)  Inputs from numpy, seeded:
z and the signal reach beyond the Legendre domain, so that the
extrapolation branch and its NO_LIN_CORR flag are taken, and the
calibration DQ carries NO_LIN_CORR and REFERENCE_PIXEL on a few pixels
(the fallback ``S - Sref``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romanimpreprocess_tpu.ops import legendre as jlegendre
from romanimpreprocess_tpu.ops import linearity as jlinearity
from romanimpreprocess_tpu_torch.dqflags import pixel
from romanimpreprocess_tpu_torch.ops import legendre, linearity

torch.set_num_threads(1)

NGRP, NY, NX = 6, 48, 40


def _lin(ncoef, seed):
    """Linearity tables (numpy): coefficients with a dominant linear
    term, Smin < Smax, Sref, and a uint32 DQ with a few fallback bits."""
    rng = np.random.default_rng(seed)
    coefs = rng.normal(0.0, 50.0, (ncoef, NY, NX)).astype(np.float32)
    coefs[0] += 3e4
    if ncoef > 1:
        coefs[1] += 3e4
    smin = rng.uniform(1000.0, 3000.0, (NY, NX)).astype(np.float32)
    smax = (smin + rng.uniform(3e4, 5e4, (NY, NX))).astype(np.float32)
    sref = (smin + rng.uniform(-100.0, 100.0, (NY, NX))).astype(np.float32)
    dq = np.zeros((NY, NX), np.uint32)
    dq[rng.uniform(size=(NY, NX)) < 0.02] |= np.uint32(pixel.NO_LIN_CORR)
    dq[rng.uniform(size=(NY, NX)) < 0.02] |= np.uint32(pixel.REFERENCE_PIXEL)
    return coefs, smin, smax, sref, dq


def _signal(shape, smin, smax, seed):
    """Signal from below Smin to above Smax (|z| up to about 1.4)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    return (smin + u * (smax - smin)).astype(np.float32)


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _packs(tables):
    coefs, smin, smax, sref, dq = tables
    jl = jlinearity.LinearityData(*(jnp.asarray(a) for a in tables))
    tl = linearity.LinearityData(
        *(torch.from_numpy(a) for a in (coefs, smin, smax, sref)),
        torch.from_numpy(dq.view(np.int32)))
    return jl, tl


@pytest.mark.parametrize("ncoef", [1, 3, 6])
@pytest.mark.parametrize("linextrap", [True, False])
def test_legendre_eval_bit_for_bit_op_by_op(ncoef, linextrap):
    rng = np.random.default_rng(ncoef)
    z = rng.uniform(-1.5, 1.5, (NGRP, NY, NX)).astype(np.float32)
    coefs = rng.normal(0.0, 1e3, (ncoef, NY, NX)).astype(np.float32)
    with jax.disable_jit():
        jphi, jflag = jlegendre.legendre_eval(jnp.asarray(z), jnp.asarray(coefs)[:, None],
                                              linextrap=linextrap)
    tphi, tflag = legendre.legendre_eval(torch.from_numpy(z),
                                         torch.from_numpy(coefs)[:, None],
                                         linextrap=linextrap)
    _same_bits(tphi.numpy(), jphi)
    np.testing.assert_array_equal(tflag.numpy(), np.asarray(jflag))
    assert tflag.any() and not tflag.all()


@pytest.mark.parametrize("ncoef", [2, 5])
def test_apply_linearity_bit_for_bit_op_by_op(ncoef):
    tables = _lin(ncoef, 10 + ncoef)
    jl, tl = _packs(tables)
    S = _signal((NY, NX), tables[1], tables[2], 20 + ncoef)
    with jax.disable_jit():
        jphi, jdq = jlinearity.apply_linearity(jnp.asarray(S), jl)
    tphi, tdq = linearity.apply_linearity(torch.from_numpy(S), tl)
    _same_bits(tphi.numpy(), jphi)
    assert tdq.dtype == torch.int32
    np.testing.assert_array_equal(tdq.numpy().view(np.uint32), np.asarray(jdq))
    assert (np.asarray(jdq) & np.uint32(pixel.NO_LIN_CORR)).any()


@pytest.mark.parametrize("do_not_flag_first", [True, False])
@pytest.mark.parametrize("with_attempt", [True, False])
def test_apply_linearity_cube_bit_for_bit_op_by_op(do_not_flag_first, with_attempt):
    tables = _lin(4, 30)
    jl, tl = _packs(tables)
    S = _signal((NGRP, NY, NX), tables[1], tables[2], 31)
    attempt = np.random.default_rng(32).uniform(size=S.shape) < 0.9
    ja = jnp.asarray(attempt) if with_attempt else None
    ta = torch.from_numpy(attempt) if with_attempt else None
    with jax.disable_jit():
        jphi, jdq = jlinearity.apply_linearity_cube(
            jnp.asarray(S), jl, do_not_flag_first=do_not_flag_first, attempt_corr=ja)
    tphi, tdq = linearity.apply_linearity_cube(
        torch.from_numpy(S), tl, do_not_flag_first=do_not_flag_first, attempt_corr=ta)
    _same_bits(tphi.numpy(), jphi)
    np.testing.assert_array_equal(tdq.numpy().view(np.uint32), np.asarray(jdq))
