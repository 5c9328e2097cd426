"""The port's calibration arithmetic held op by op to the JAX package.

The JAX functions run under ``jax.disable_jit()``: every primitive is
its own XLA computation, so no fusion (no multiply-add contraction)
changes the reference's roundings, and the port's plain PyTorch on the
CPU must repeat them bit for bit.  Cases, on inputs built once with
numpy from a seed (the JAX package's ``benchlib.core_bundle``, with a
sky gradient, 1% bright pixels, noisy amp33 columns and, for the jump
case, steps of 2000-5000 DN between two groups in 1% of the pixels):

- the L1 -> L2 core (the JAX ``make_core``, jitted there and run op by
  op here, against the port's ``make_core``): classic fit at 64^2 and
  128^2 (with the jumps), likelihood fit at 64^2, ``SKYORDER: 2``;
- the IPC precal (``l1_to_l2.ipc_precal``) and the sim's deterministic
  forward model (``sim_to_l1.IL.apply``: forward IPC, then the
  bisection inverse of the linearity) on a 64^2 cube of 6 resultants.

Gates.  DQ planes and ``endslice`` equal, no loose bit; every float
output bit for bit (its int32 view equal, NaN where NaN).  Two kinds of
step may not be: a BLAS product or LAPACK solve, whose order of
summation neither package sets (the fit's ``W @ diffs``,
``ramp.candidate_slopes``; the sky's normal equations,
``sky.normal_solve``), and an elementwise primitive that XLA on the CPU
does not round correctly (``exp``, ``log``, ``rsqrt``, each within 1
ulp).  Each is pinned by a one-op test with its tolerance in ulps, and
the core is then held bit for bit with the reference's value of those
steps put in place of the port's (:func:`_reference_steps`).  Run as it
is, the port keeps every DQ bit, its per-pixel maps differ from the
reference only where its candidate-slope product does, and its sky
only by the ulps its own solve and those maps give.  The steps
the port takes to repeat the reference's roundings are held one op
each: the sky mode's summation tree (``sky.tree_leaves``, also over a
three-level tree), quantiles and grids (``sky.nanquantile``,
``sky.linspace32``) and the square root (``ramp.sqrt_rn``).

``JAX_PLATFORMS=cpu python tests/test_torch_opbyop.py`` (with the
repository on ``PYTHONPATH``) prints the residuals these gates bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romanimpreprocess_tpu import benchlib as jbenchlib
from romanimpreprocess_tpu.ops import linearity as jlinearity
from romanimpreprocess_tpu.pipeline import l1_to_l2 as jl1_to_l2
from romanimpreprocess_tpu.pipeline import sim_to_l1 as jsim_to_l1
from romanimpreprocess_tpu_torch import benchlib
from romanimpreprocess_tpu_torch.dqflags import pixel
from romanimpreprocess_tpu_torch.io import staging
from romanimpreprocess_tpu_torch.ops import ipc_cuda, linearity, ramp, sky
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, sim_to_l1

torch.set_num_threads(1)

NB = 4
JUMP_DET = np.uint32(pixel.JUMP_DET)
CASES = {
    "classic_64": (64, False, False),
    "classic_128_jumps": (128, False, True),
    "likelihood_64": (64, True, False),
}
#: |port - reference| of the fit's product, in ulps of sum_k |W_k d_k|
#: (measured 2 at 128^2, 0 at 64^2: ``main``)
PRODUCT_ULPS = 4
#: |port - reference| of the sky coefficients, in ulps of max |c|, of
#: ``sky.normal_solve`` alone on an 8 x 8 grid (measured 0.41)
SOLVE_ULPS = 2
#: the same for the cores as they run, on their own systems (measured
#: 7.9 classic and 8.5 likelihood at 64^2, 5.0 at 128^2: ``main``)
CORE_SKY_ULPS = 16
#: |port - reference| of ``medsky`` as the cores run, in ulps (measured
#: 3 at 128^2, where the product parts ``slope_withsky``; 0 at 64^2)
MEDSKY_ULPS = 4


def _ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.spacing(np.maximum(x, np.finfo(np.float32).tiny))


def _same_bits(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if got.dtype.kind == "f":
        nan = np.isnan(got)
        np.testing.assert_array_equal(nan, np.isnan(want), name)
        np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                      want.view(np.int32)[~nan], name)
    else:
        np.testing.assert_array_equal(got, want, name)


def to_port(arr, nside):
    """The JAX bundle's host arrays as the port's CPU tensors, staged as
    the port stages them (uint32 DQ as int32 bit patterns, the counts as
    float32, the IPC kernel's frame planes)."""
    out = {}
    for k, v in arr.items():
        if k in ("ipc_kernel_padded", "ipc_kernel_frame"):
            continue
        v = np.asarray(v)
        out[k] = (torch.from_numpy(v.copy()) if v.ndim == 0
                  else staging.stage(v, "cpu", cache=False))
    out["data"] = out["data"].to(torch.float32)
    out["ipc_kernel_frame"] = staging.stage(
        ipc_cuda.kernel_planes_frame(arr["ipc_kernel"], nside, NB), "cpu", cache=False)
    return out


def _inputs(nside, likelihood, jumps):
    """(JAX bundle, plan, cfg, geom, injected-jump mask or None)."""
    arr, plan, cfg, geom = jbenchlib.core_bundle(nside=nside, likelihood=likelihood)
    rng = np.random.default_rng(nside + 10 * likelihood + 100 * jumps)
    ngrp = arr["data"].shape[0]
    yy, xx = np.mgrid[:nside, :nside] / nside
    rate = 20 + 10 * xx + 5 * yy**2 + 500 * (rng.uniform(size=(nside, nside)) < 0.01)
    t = np.array([3.04 * np.mean(g) for g in jbenchlib.READ_PATTERN_DEFAULT])
    data = arr["data"] + rate[None] * t[:, None, None]
    hit = None
    if jumps:
        hit = rng.uniform(size=(nside, nside)) < 0.01
        grp = rng.integers(2, ngrp, (nside, nside))
        step = rng.uniform(2000.0, 5000.0, (nside, nside))
        data = data + (np.arange(ngrp)[:, None, None] >= grp) * (hit * step)
    arr["data"] = np.clip(np.round(data), 0, 65535).astype(np.uint16)
    arr["amp33"] = (arr["amp33"] + rng.normal(0.0, 5.0, arr["amp33"].shape)).astype(np.float32)
    with jax.disable_jit():
        arr["dark_slope_ipc"], arr["flat_ipc"] = jl1_to_l2.ipc_precal(
            arr["flat"].copy(), arr["dark_slope"].copy(), arr["gain"].copy(),
            arr["ipc_kernel"].copy(), NB)
    return arr, plan, cfg, geom, hit


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """The reference's core outputs, op by op, and the port's inputs."""
    nside, likelihood, jumps = CASES[request.param]
    arr, plan, cfg, geom, hit = _inputs(nside, likelihood, jumps)
    with jax.disable_jit():
        ref = jl1_to_l2.make_core(plan, cfg, geom)({k: jnp.asarray(v) for k, v in arr.items()})
    ref = {k: np.asarray(v) for k, v in ref.items()}
    _, tplan, tcfg, tgeom = benchlib.core_bundle(nside=nside, likelihood=likelihood,
                                                 device="cpu")
    assert tcfg["ipc"] == "xla" and tgeom == geom
    return dict(name=request.param, ref=ref, arr=to_port(arr, nside), hit=hit,
                core=l1_to_l2.make_core(tplan, tcfg, tgeom))


def _on_jax(fn):
    """A torch op that returns the JAX function's value on the same
    CPU tensors."""
    def op(*args):
        return torch.from_numpy(np.array(fn(*(jnp.asarray(a.numpy()) for a in args))))
    return op


def _jax_product(W, diffs):
    return jnp.dot(W, diffs, preferred_element_type=jnp.float32, precision="highest")


def _jax_normal_solve(bflat, m):
    return jnp.linalg.solve(bflat @ bflat.T, bflat @ m)


def _reference_steps(mp):
    """Put the reference's value of each pinned step in place of the
    port's: the BLAS / LAPACK steps and the primitives XLA does not
    round correctly."""
    mp.setattr(ramp, "candidate_slopes", _on_jax(_jax_product))
    mp.setattr(sky, "normal_solve", _on_jax(_jax_normal_solve))
    mp.setattr(torch, "exp", _on_jax(jnp.exp))
    mp.setattr(torch, "log", _on_jax(jnp.log))
    mp.setattr(torch, "rsqrt", _on_jax(jax.lax.rsqrt))


def test_core_bit_for_bit_with_the_reference_steps(case, monkeypatch):
    with monkeypatch.context() as mp, jax.disable_jit():
        _reference_steps(mp)
        got = staging.to_host(case["core"](case["arr"]))
    assert set(got) == set(case["ref"])
    for k, want in case["ref"].items():
        _same_bits(got[k], want, k)


def test_core_as_it_runs(case, monkeypatch):
    """The port's own steps: every DQ bit and ``endslice`` equal, the
    read error bit for bit, the other per-pixel maps apart only where
    the candidate-slope product is, the sky coefficients within
    CORE_SKY_ULPS ulps of the largest and ``medsky`` within MEDSKY_ULPS
    ulps."""
    apart = []

    def spy(W, diffs):
        out = ramp.candidate_slopes.__wrapped__(W, diffs)
        with jax.disable_jit():
            ref = np.asarray(_jax_product(jnp.asarray(W.numpy()), jnp.asarray(diffs.numpy())))
        apart.append((out.numpy() != ref).any(axis=0))
        return out

    spy.__wrapped__ = ramp.candidate_slopes
    monkeypatch.setattr(ramp, "candidate_slopes", spy)
    got = staging.to_host(case["core"](case["arr"]))
    ref = case["ref"]
    for k in ("pdq", "endslice", "slope_err_read"):
        _same_bits(got[k], ref[k], k)
    nside = ref["pdq"].shape[0]
    # the likelihood fit sums its weights group by group: no product
    product_apart = np.zeros((nside, nside), bool)
    for a in apart:
        product_apart |= a.reshape(nside, nside)
    for k in ("slope_withsky", "slope_err_poisson", "dumo", "chisq"):
        if k in ref:
            off = got[k].view(np.int32) != ref[k].view(np.int32)
            assert not (off & ~product_apart).any(), k
    for k in ("slope", "medsky", "skycoefs"):
        assert got[k].shape == ref[k].shape and np.isfinite(got[k]).all(), k
    assert _core_sky_ulps(got, ref) <= CORE_SKY_ULPS
    assert _ulps(got["medsky"], ref["medsky"]).max() <= MEDSKY_ULPS


def _core_sky_ulps(got, ref):
    """|port - reference| of the sky coefficients in ulps of max |c|."""
    c = ref["skycoefs"]
    return float((np.abs(got["skycoefs"].astype(np.float64) - c) / _ulp(np.abs(c).max())).max())


@pytest.mark.parametrize("case", ["classic_128_jumps"], indirect=True)
def test_jumps_fire_on_the_injected_steps(case):
    pdq = case["ref"]["pdq"]
    inner = np.zeros_like(case["hit"])
    inner[NB:-NB, NB:-NB] = True
    hit = case["hit"] & inner
    flagged = (pdq & JUMP_DET) != 0
    assert hit.sum() > 50
    assert flagged[hit].mean() > 0.8
    assert flagged.mean() < 0.05


def test_ipc_precal_bit_for_bit():
    arr, _, _, _, _ = _inputs(64, False, False)
    planes = [arr[k].copy() for k in ("flat", "dark_slope", "gain", "ipc_kernel")]
    with jax.disable_jit():  # also the reference's own jax.jit(ipc.ipc_rev)
        want = jl1_to_l2.ipc_precal(*[p.copy() for p in planes], NB)
    got = l1_to_l2.ipc_precal(*planes, NB, "cpu")
    for g, w, name in zip(got, want, ("dark_slope_ipc", "flat_ipc")):
        _same_bits(g.numpy(), np.asarray(w), name)


def test_sim_forward_model_bit_for_bit():
    """``IL.apply``: forward IPC of a (6, 56, 56) electron cube, the
    gain, the 24-step bisection inverse of the linearity."""
    nside, ngrp = 64, 6
    arr, _, _, _, _ = _inputs(nside, False, False)
    rng = np.random.default_rng(7)
    na = nside - 2 * NB
    counts = np.cumsum(rng.uniform(0.0, 9000.0, (ngrp, na, na)), axis=0).astype(np.float32)
    start = rng.uniform(0.0, 100.0, (na, na)).astype(np.float32)
    lin = [arr[k] for k in ("lin_coefs", "lin_smin", "lin_smax", "lin_sref", "lin_dq")]
    with jax.disable_jit():
        model = jsim_to_l1.IL(jlinearity.LinearityData(*(jnp.asarray(a) for a in lin)),
                              jnp.asarray(arr["gain"]), jnp.asarray(arr["ipc_kernel"]),
                              start_e=jnp.asarray(start))
        want = np.asarray(model.apply(jnp.asarray(counts)))
    tl = [staging.stage(a, "cpu", cache=False) for a in lin]
    got = sim_to_l1.IL(linearity.LinearityData(*tl), torch.from_numpy(arr["gain"]),
                       torch.from_numpy(arr["ipc_kernel"]),
                       start_e=torch.from_numpy(start)).apply(torch.from_numpy(counts))
    _same_bits(got.numpy(), want, "S")
    assert np.ptp(want) > 1e4


@pytest.mark.parametrize("n", [5, 32, 33, 100, 1250, 40000])
def test_summation_tree_is_the_reference_sum(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(3, n)) * 10.0 ** rng.uniform(-3, 3, (3, n))).astype(np.float32)
    x[2] = -0.0  # the init value's sign: +0
    with jax.disable_jit():
        ref = np.asarray(jnp.sum(jnp.asarray(x), axis=1))
    leaves = sky.tree_leaves(n, "cpu")
    t = torch.cat([torch.from_numpy(x.T), torch.zeros(1, 3)])[leaves]  # (tree..., 3)
    _same_bits(sky.tree_sum_leaves(t, leaves.dim()).numpy(), ref, "sum")


def test_smooth_mode_over_a_deep_summation_tree(monkeypatch):
    """``smooth_mode`` on 300^2 values (a three-level tree with padding
    at every level; the cores' frames take one level) with XLA's ``exp``
    put in: bit for bit."""
    rng = np.random.default_rng(6)
    x = rng.normal(20.0, 3.0, (300, 300)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.1] = np.nan
    from romanimpreprocess_tpu.ops import sky as jsky
    with jax.disable_jit():
        ref = [np.asarray(v) for v in jsky.smooth_mode(jnp.asarray(x))]
    monkeypatch.setattr(torch, "exp", _on_jax(jnp.exp))
    got = sky.smooth_mode(torch.from_numpy(x))
    for g, r, name in zip(got, ref, ("mode", "width")):
        _same_bits(g.numpy(), r, name)


@pytest.mark.parametrize("lo,hi,n", [(-1.0, 1.0, 21), (0.5, 7.5, 8),
                                     (-1.0, 1.0 - 2.0 / 120, 120)])
def test_linspace32_is_the_reference_linspace(lo, hi, n):
    with jax.disable_jit():
        ref = np.asarray(jnp.linspace(lo, hi, n))
    _same_bits(sky.linspace32(lo, hi, n, "cpu").numpy(), ref, "linspace")


@pytest.mark.parametrize("n,nan_share", [(1000, 0.0), (997, 0.3)])
def test_nanquantile_is_the_reference_quantile(n, nan_share):
    rng = np.random.default_rng(n)
    x = (rng.normal(0, 1, n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    x[rng.uniform(size=n) < nan_share] = np.nan
    qs = np.arange(1, 100, dtype=np.float32) / np.float32(100)
    with jax.disable_jit():
        ref = np.asarray(jnp.nanquantile(jnp.asarray(x), jnp.asarray(qs)))
    _same_bits(sky.nanquantile(torch.from_numpy(x), qs).numpy(), ref, "quantiles")


# ---------------------------------------------------------------------------
# The pinned steps, one op each
# ---------------------------------------------------------------------------

def _cr(fn, x):
    """The correctly rounded float32 value (float64, rounded once)."""
    return fn(np.asarray(x, np.float64)).astype(np.float32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_sqrt_is_correctly_rounded_in_both():
    """The reference's ``sqrt`` is IEEE's; the port's ``ramp.sqrt_rn``
    (the Poisson and read errors of both fits) is too."""
    rng = np.random.default_rng(1)
    x = (10.0 ** rng.uniform(-30, 30, 1 << 18)).astype(np.float32)
    with jax.disable_jit():
        ref = np.asarray(jnp.sqrt(jnp.asarray(x)))
    np.testing.assert_array_equal(ref, np.sqrt(x))
    np.testing.assert_array_equal(ramp.sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))


@pytest.mark.parametrize("name,lo,hi", [
    ("exp", -80.0, 0.0),     # the smoothed histogram's weights, exp(-d^2 / 2)
    ("log", 1e-6, 1e8),      # the jump threshold; the likelihood fit's u bin
    ("rsqrt", 1e-2, 1e8),    # the jump significance, ds / sqrt(var)
])
def test_xla_primitive_within_one_ulp(name, lo, hi):
    """XLA's ``exp``, ``log`` and ``rsqrt`` on the CPU are not correctly
    rounded: on a share of the values they are 1 ulp off it, never
    more.  PyTorch's are within 1 ulp of it too.  So the port and the
    reference may differ by these ulps at these ops and no others."""
    rng = np.random.default_rng(2)
    x = (rng.uniform(lo, hi, 1 << 18) if name == "exp"
         else 10.0 ** rng.uniform(np.log10(lo), np.log10(hi), 1 << 18)).astype(np.float32)
    jfn = {"exp": jnp.exp, "log": jnp.log, "rsqrt": jax.lax.rsqrt}[name]
    tfn = {"exp": torch.exp, "log": torch.log, "rsqrt": torch.rsqrt}[name]
    cfn = {"exp": np.exp, "log": np.log, "rsqrt": lambda v: 1.0 / np.sqrt(v)}[name]
    with jax.disable_jit():
        ref = np.asarray(jfn(jnp.asarray(x)))
    cr = _cr(cfn, x)
    assert _ulps(ref, cr).max() == 1
    assert (ref != cr).mean() > 1e-3
    assert _ulps(tfn(torch.from_numpy(x)).numpy(), cr).max() <= 1


@pytest.mark.parametrize("nside", [64, 128])
def test_candidate_slope_product_within_ulps(nside):
    """The fit's ``W @ diffs``: both sides sum the 6 groups' products
    with fused multiply-adds, in an order of their library's choosing
    (XLA's changes between 64^2 and 128^2 pixels).  They agree within
    PRODUCT_ULPS ulps of sum_k |W_k d_k|."""
    _, plan, _, _, _ = _inputs(nside, False, False)
    rng = np.random.default_rng(nside)
    W = np.asarray(plan.W, np.float32)
    diffs = (rng.normal(0.0, 1.0, (W.shape[1], nside * nside))
             * 10.0 ** rng.uniform(0, 4, (1, nside * nside))).astype(np.float32)
    with jax.disable_jit():
        ref = np.asarray(_jax_product(jnp.asarray(W), jnp.asarray(diffs)))
    got = ramp.candidate_slopes(torch.from_numpy(W), torch.from_numpy(diffs)).numpy()
    scale = np.abs(W.astype(np.float64)) @ np.abs(diffs.astype(np.float64))
    assert (np.abs(got.astype(np.float64) - ref) <= PRODUCT_ULPS * _ulp(scale)).all()
    if nside == 128:
        assert (got != ref).any()


def _sky_system():
    """(bflat, m): medfit's basis rows and block medians on an 8 x 8
    grid, order 2, a few blocks empty."""
    rng = np.random.default_rng(3)
    N, order = 8, 2
    u = sky.linspace32(-0.875, 0.875, N, "cpu")
    P = [torch.ones(N), u, 1.5 * u * u - 0.5]
    terms = [(i, j) for i in range(order + 1) for j in range(order + 1 - i)]
    basis = torch.stack([P[j][:, None] * P[i][None, :] for i, j in terms]).reshape(len(terms), -1)
    good = torch.from_numpy(rng.uniform(size=N * N) > 0.03)
    m = torch.from_numpy((25 + rng.normal(0, 3, N * N)).astype(np.float32)) * good
    return basis * good[None, :], m


def _solve_ulps():
    bflat, m = _sky_system()
    with jax.disable_jit():
        ref = np.asarray(_jax_normal_solve(jnp.asarray(bflat.numpy()), jnp.asarray(m.numpy())))
    got = sky.normal_solve(bflat, m).numpy()
    return np.abs(got - ref) / _ulp(np.abs(ref).max())


def test_sky_normal_solve_within_ulps():
    """The sky's normal equations (a BLAS product) and their LAPACK
    solve: within SOLVE_ULPS ulps of the largest coefficient."""
    assert (_solve_ulps() <= SOLVE_ULPS).all()

def main():
    """Print (one JSON line) what the gates above bound: per core case,
    the reference's op-by-op time and, per output, the share of values
    whose bits differ and the largest difference in ulps, for the port
    as it runs and with the reference's steps; per pinned step, its
    measured distance.  ``JAX_PLATFORMS=cpu python tests/test_torch_opbyop.py``."""
    import json
    import time

    from romanimpreprocess_tpu_torch.utils.parity import bit_differences

    rep = {"cases": {}, "steps": {}}
    for name, (nside, likelihood, jumps) in CASES.items():
        arr, plan, cfg, geom, _ = _inputs(nside, likelihood, jumps)
        t0 = time.perf_counter()
        with jax.disable_jit():
            ref = jl1_to_l2.make_core(plan, cfg, geom)({k: jnp.asarray(v) for k, v in arr.items()})
        ref = {k: np.asarray(v) for k, v in ref.items()}
        seconds = time.perf_counter() - t0
        _, tplan, tcfg, tgeom = benchlib.core_bundle(nside=nside, likelihood=likelihood,
                                                     device="cpu")
        core, tarr = l1_to_l2.make_core(tplan, tcfg, tgeom), to_port(arr, nside)
        got = staging.to_host(core(tarr))
        as_runs = bit_differences(ref, got)
        as_runs["skycoefs"]["max_ulps_of_max_coef"] = _core_sky_ulps(got, ref)
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            _reference_steps(mp)
            steps = bit_differences(ref, staging.to_host(core(tarr)))
        rep["cases"][name] = {"reference_op_by_op_s": seconds, "as_it_runs": as_runs,
                              "with_reference_steps": steps}
    rng = np.random.default_rng(2)
    for name, jfn, tfn, cfn, x in (
            ("exp", jnp.exp, torch.exp, np.exp, rng.uniform(-80.0, 0.0, 1 << 18)),
            ("log", jnp.log, torch.log, np.log, 10.0 ** rng.uniform(-6, 8, 1 << 18)),
            ("rsqrt", jax.lax.rsqrt, torch.rsqrt, lambda v: 1.0 / np.sqrt(v),
             10.0 ** rng.uniform(-2, 8, 1 << 18))):
        x = x.astype(np.float32)
        with jax.disable_jit():
            ref = np.asarray(jfn(jnp.asarray(x)))
        cr, port = _cr(cfn, x), tfn(torch.from_numpy(x)).numpy()
        rep["steps"][name] = {"reference_apart_share": float((ref != cr).mean()),
                              "reference_max_ulps": int(_ulps(ref, cr).max()),
                              "port_apart_share": float((port != cr).mean()),
                              "port_max_ulps": int(_ulps(port, cr).max())}
    for nside in (64, 128):
        _, plan, _, _, _ = _inputs(nside, False, False)
        rng = np.random.default_rng(nside)
        W = np.asarray(plan.W, np.float32)
        diffs = (rng.normal(0.0, 1.0, (W.shape[1], nside * nside))
                 * 10.0 ** rng.uniform(0, 4, (1, nside * nside))).astype(np.float32)
        with jax.disable_jit():
            ref = np.asarray(_jax_product(jnp.asarray(W), jnp.asarray(diffs)))
        got = ramp.candidate_slopes(torch.from_numpy(W), torch.from_numpy(diffs)).numpy()
        scale = np.abs(W.astype(np.float64)) @ np.abs(diffs.astype(np.float64))
        rep["steps"][f"candidate_slopes_{nside}"] = {
            "apart_share": float((got != ref).mean()),
            "max_ulps_of_scale": float((np.abs(got.astype(np.float64) - ref)
                                        / _ulp(scale)).max())}
    rep["steps"]["normal_solve"] = {"max_ulps_of_max_coef": float(_solve_ulps().max())}
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
