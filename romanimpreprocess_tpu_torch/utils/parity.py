"""The slice's parity gates, as functions that raise.

The port's products are held to the JAX package on the CPU and, on the
card, the port's own paths to each other.  These are the rules, in one
place, for the checks that run where JAX is not installed (the GPU
machine): ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

- :func:`compare_outputs`: two L1 -> L2 core outputs (``to_host`` dicts:
  ``slope``, ``pdq``, ``skycoefs`` ...; with the likelihood fit also
  ``dumo`` and ``chisq``), or the same fields of two L2 trees
  (``chip_smoke.py``).  DQ bit for bit except JUMP_DET on at most
  1e-4 of the pixels; the maps within rtol 1e-5 + atol 1e-5 max|ref|
  (a pixel whose JUMP_DET differs may fit another slope); ``skycoefs``
  and ``medsky`` within rtol 1e-4, or (``sky="derived"``, for two
  L2 trees whose slopes round apart) within the bound that the
  measured difference of ``data_withsky`` puts on them
  (:func:`sky_bounds`);
  ``endslice`` exact; ``dumo`` and
  ``chisq`` after the cast to float16 within one float16 ulp + atol 1e-5
  max|ref| on at least 99.9% of the pixels.  These are the gates of
  ``tests/test_torch_l1_to_l2.py`` against the JAX package.  Two routes
  that round differently (the slab and frame IPC inverses) are held with
  the arguments that say how far they may differ.
- :func:`compare_noise`: two noise cubes of one exposure from different
  random streams: per layer, on good pixels, the 5-95% spread within
  0.75-1.33 of the reference's and |median| < 0.3
  (``tests/test_noise.py``, ``tests/test_torch_noise.py``);
  :func:`o_tracks_signal`: an 'O' layer's std over the brightest 5% of
  the pixels above 1.5 times its std over the faintest 50%.
- :func:`compare_moments`: two samplers' resultants over several seeds
  (the RNG streams differ): per group the mean over pixels of the seed
  mean, and of the seed variance, within 4 sigma of their sampling
  error (``tests/test_torch_sim.py``).
- :func:`sim_envelope`: a simulated exposure through ``calibrateimage``
  at 120^2 active pixels recovers its scene and its cosmic rays, at the
  JAX package's gates (``tests/test_workflow.py``, ``test_run_all.py``).
- :func:`mc_stack`: a Monte-Carlo statistics stack
  (``validation.many_realizations``) at the JAX package's gates
  (``tests/test_validation.py``).
- :func:`same_tree`: two ASDF trees of one product from two of the
  port's paths (serial and focal-plane): the same keys, types and
  values, arrays bit for bit, the L2 log's ``Timing:`` lines aside.
- :func:`row_shard_gate`: the row-sharded core's outputs
  (``parallel.spatial``) against the single-SCA core's on one bundle,
  at the JAX package's ``tests/test_spatial.py`` gate: integer outputs
  bit for bit, float outputs within 1e-4 of ``1 + |ref|`` (``chisq``
  and ``dumo`` 1e-3).
"""

import numpy as np

JUMP_DET = 4
MAPS = ("slope", "slope_withsky", "slope_err_read", "slope_err_poisson")
FLOAT16 = ("dumo", "chisq")


class ParityError(AssertionError):
    pass


def _require(cond, what):
    if not cond:
        raise ParityError(what)


def compare_outputs(ref, got, what, maps=MAPS, loose_bits=JUMP_DET, atol_frac=1e-5,
                    outside_frac=0.0, sky="rtol"):
    """Hold the outputs ``got`` to ``ref``; returns what was measured
    (largest differences, shares outside, bit equality).

    ``maps``: the float maps held to rtol 1e-5 + ``atol_frac`` max|ref|
    on all but ``outside_frac`` of the pixels; ``loose_bits``: the DQ
    bits that may differ (on at most 1e-4 of the pixels); ``sky``:
    ``"rtol"`` holds ``skycoefs`` and ``medsky`` within rtol 1e-4,
    ``"derived"`` within :func:`sky_bounds` of ``data_withsky``, the map
    the sky is fitted to (the outputs of two L2 trees: the active
    region).
    """
    _require(sky in ("rtol", "derived"), f"{what}: unknown sky gate {sky!r}")
    _require(set(got) == set(ref), f"{what}: outputs {sorted(got)} vs {sorted(ref)}")
    diff = ref["pdq"] ^ got["pdq"]
    _require(not (diff & ~np.uint32(loose_bits)).any(),
             f"{what}: DQ differs beyond bits {loose_bits}")
    jump = diff != 0
    rep = {"jump_det_diff_frac": float(jump.mean())}
    _require(rep["jump_det_diff_frac"] <= 1e-4,
             f"{what}: JUMP_DET differs on {rep['jump_det_diff_frac']} of pixels")
    tight = {}
    for k in maps:
        r, g = ref[k], got[k]
        scale = float(np.abs(r).max())
        ok = np.abs(g - r) <= 1e-5 * np.abs(r) + atol_frac * scale
        tight[k] = ok & ~jump
        rep[k + "_max_abs_err"] = float(np.abs(g - r).max())
        rep[k + "_outside_frac"] = float(1.0 - (ok | jump).mean())
        _require(rep[k + "_outside_frac"] <= outside_frac,
                 f"{what}: {k} differs on {rep[k + '_outside_frac']} of pixels "
                 f"(largest {rep[k + '_max_abs_err']} of {scale})")
    sr, sg = ref["skycoefs"], got["skycoefs"]
    ms_r, ms_g = float(ref["medsky"]), float(got["medsky"])
    rep["skycoefs_max_abs_err"] = float(np.abs(sg - sr).max(initial=0.0))
    rep["skycoefs_max_abs"] = float(np.abs(sr).max(initial=0.0))
    rep["medsky_abs_err"] = abs(ms_g - ms_r)
    if sky == "rtol":
        rep["skycoefs_within_gate"] = bool(
            np.allclose(sg, sr, rtol=1e-4, atol=1e-4 * rep["skycoefs_max_abs"]))
        rep["medsky_within_gate"] = bool(np.isclose(ms_g, ms_r, rtol=1e-4))
    else:
        loose = ~tight["data_withsky"] if "data_withsky" in tight else jump
        bounds = sky_bounds(ref["data_withsky"], got["data_withsky"], loose, sr, ms_r)
        rep.update(bounds)
        rep["skycoefs_within_gate"] = bool(
            (np.abs(sg - sr) <= bounds["skycoefs_bound"]).all())
        rep["medsky_within_gate"] = bool(rep["medsky_abs_err"] <= bounds["medsky_bound"])
    _require(rep["skycoefs_within_gate"], f"{what}: skycoefs {sg} vs {sr}")
    _require(rep["medsky_within_gate"], f"{what}: medsky {ms_g} vs {ms_r}")
    _require(np.array_equal(got["endslice"], ref["endslice"]), f"{what}: endslice")
    for k in FLOAT16:
        if k not in ref:
            continue
        r = np.asarray(ref[k]).astype(np.float16)
        g = np.asarray(got[k]).astype(np.float16)
        ulp = np.spacing(np.maximum(np.abs(r), np.abs(g))).astype(np.float32)
        r32, g32 = r.astype(np.float32), g.astype(np.float32)
        ok = np.abs(g32 - r32) <= ulp + 1e-5 * np.abs(r32).max()
        rep[k + "_outside_frac"] = float(1.0 - ok.mean())
        _require(ok.mean() >= 0.999,
                 f"{what}: {k} outside one float16 ulp on {rep[k + '_outside_frac']}")
    rep["bit_exact"] = all(np.array_equal(ref[k], got[k]) for k in ref)
    return rep


def _ordered(a):
    """float32 values as int64 keys in the order of the floats, one
    apart for adjacent floats (-0 and +0 share a key)."""
    i = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def bit_differences(ref, got):
    """Per output of two runs (dicts of arrays, the same keys): the
    share of the values whose bits differ (NaN equal to NaN) and, for
    float32 outputs, the largest difference between numbers in ulps and
    in value (a NaN against a number counts in the share only).  The
    ulps count the floats between the two values, so two small values
    on either side of 0 read millions of ulps apart.  Reported, not
    gated."""
    rep = {}
    for k in sorted(ref):
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        if a.dtype.kind == "f":
            a32, b32 = a.astype(np.float32), b.astype(np.float32)
            nan_a, nan_b = np.isnan(a32), np.isnan(b32)
            off = (a32.view(np.int32) != b32.view(np.int32)) & ~(nan_a & nan_b)
            num = ~(nan_a | nan_b)
            ulps = np.abs(_ordered(a32[num]) - _ordered(b32[num]))
            dif = np.abs(a32[num].astype(np.float64) - b32[num])
            rep[k] = {"share": float(off.mean()) if off.size else 0.0,
                      "max_ulps": int(ulps.max()) if ulps.size else 0,
                      "max_abs": float(dif.max()) if dif.size else 0.0}
        else:
            off = a != b
            rep[k] = {"share": float(off.mean()) if off.size else 0.0, "max_ulps": None,
                      "max_abs": None}
    return rep


def row_shard_gate(ref, got, what):
    """Hold the row-sharded core's outputs ``got`` to the single core's
    ``ref`` (dicts of tensors or arrays, same keys and shapes): integers
    bit for bit, floats within ``max |got - ref| / (1 + |ref|)`` < 1e-4
    (1e-3 for ``chisq`` and ``dumo``, sums over groups).  Returns the
    measured drift per output (0.0 where equal)."""
    _require(set(got) == set(ref), f"{what}: outputs {sorted(got)} vs {sorted(ref)}")
    drift = {}
    for k in ref:
        a, b = (np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in (ref[k], got[k]))
        _require(a.shape == b.shape, f"{what}: {k} shape {b.shape} vs {a.shape}")
        if a.dtype.kind in "ui":
            _require(np.array_equal(a, b), f"{what}: {k} integers differ")
            drift[k] = 0.0
            continue
        drift[k] = float(np.max(np.abs(a - b) / (1.0 + np.abs(a)))) if a.size else 0.0
        tol = 1e-3 if k in FLOAT16 else 1e-4
        _require(drift[k] < tol, f"{what}: {k} drift {drift[k]} (gate {tol})")
    return drift


#: the sky stages of the core: ``medfit``'s N x N block grid and the
#: k x k binning under ``smooth_mode``
SKY_BLOCKS = 8
SKY_BIN = 4


def medfit_matrix(ny, nx, good, order, N=SKY_BLOCKS):
    """The linear map (float64, (ncoef, N*N)) from the N x N block
    medians of an (ny, nx) map, row-major, to ``ops.sky.medfit``'s
    coefficients: the least-squares solve over the blocks in ``good``."""
    ky, kx, py, px = ny // N, nx // N, (ny % N) // 2, (nx % N) // 2
    c = np.arange(N) + 0.5
    pu = np.polynomial.legendre.legvander(2 * (px - 0.5 + kx * c) / nx - 1, order).T
    pv = np.polynomial.legendre.legvander(2 * (py - 0.5 + ky * c) / ny - 1, order).T
    terms = [(i, j) for i in range(order + 1) for j in range(order + 1 - i)]
    B = np.stack([np.outer(pv[j], pu[i]).ravel() for i, j in terms]) * good.ravel()
    return np.linalg.solve(B @ B.T, B)


def _rows(a, N):
    """The N x N blocks of ``medfit``'s grid as rows."""
    ny, nx = a.shape
    ky, kx, py, px = ny // N, nx // N, (ny % N) // 2, (nx % N) // 2
    return (a[py:py + N * ky, px:px + N * kx].reshape(N, ky, N, kx)
            .transpose(0, 2, 1, 3).reshape(N * N, ky * kx))


def _median_shift(vals, k):
    """Per row of ``vals``: how far its median can move when ``k`` of
    its values change arbitrarily (each order statistic j then lies
    between statistics j - k and j + k of ``vals``)."""
    s = np.sort(vals, axis=1)  # NaN last
    cnt = np.isfinite(vals).sum(axis=1)
    lo, hi = (cnt - 1) // 2, cnt // 2

    def at(j):
        j = np.clip(j, 0, np.maximum(cnt - 1, 0))
        return np.take_along_axis(s, j[:, None], 1)[:, 0]

    mid = 0.5 * (at(lo) + at(hi))
    shift = np.maximum(0.5 * (at(lo + k) + at(hi + k)) - mid,
                       mid - 0.5 * (at(lo - k) + at(hi - k)))
    return np.where(cnt > 0, shift, 0.0)


def sky_bounds(ref_map, got_map, loose, skycoefs, medsky):
    """How far ``skycoefs`` and ``medsky`` may move between two
    calibrations whose sky maps (the region the sky fit reads) differ by
    what was measured.  ``loose``: the pixels the map gates let differ
    freely (JUMP_DET differs, or outside the gate).

    - ``sky_delta``: the largest |got - ref| over the other pixels.
    - A median of values that each move by at most ``sky_delta`` moves
      by at most that; a loose value may take any place in the order, so
      ``k`` loose values move a block's median by at most ``k`` order
      statistics of the reference block, plus ``sky_delta``.
    - ``skycoefs`` are a fixed linear map A of the block medians
      (:func:`medfit_matrix`): per coefficient ``1e-4 max|c| + |A| @``
      the blocks' bounds.
    - ``medsky``, the mode of the 4 x 4 bin means, is held the same way:
      ``1e-4 |medsky| + sky_delta`` plus, for the ``k`` bins a loose pixel
      reaches through the mask's growth, the gap of ``k`` order
      statistics of the reference's bin means around ``medsky``.
    """
    ref_map = np.asarray(ref_map, np.float64)
    got_map = np.asarray(got_map, np.float64)
    loose = loose | (np.isfinite(ref_map) != np.isfinite(got_map))
    d = np.abs(got_map - ref_map)[~loose & np.isfinite(ref_map)]
    delta = float(d.max(initial=0.0))
    rep = {"sky_delta": delta, "sky_loose_pixels": int(loose.sum())}

    nc = len(skycoefs)
    if nc:
        order = int(round((np.sqrt(8 * nc + 1) - 3) / 2))
        vals = _rows(ref_map, SKY_BLOCKS)
        k = _rows(loose, SKY_BLOCKS).sum(axis=1)
        beta = delta + _median_shift(vals, k)
        good = np.isfinite(vals).any(axis=1)
        A = medfit_matrix(*ref_map.shape, good, order)
        bound = 1e-4 * np.abs(skycoefs).max() + np.abs(A) @ beta
    else:
        bound = np.zeros(0)
    rep["skycoefs_bound"] = [float(b) for b in bound]

    ny, nx = (n // SKY_BIN for n in ref_map.shape)
    blk = (slice(0, ny * SKY_BIN), slice(0, nx * SKY_BIN))
    bins = ref_map[blk].reshape(ny, SKY_BIN, nx, SKY_BIN).mean(axis=(1, 3))
    hit = loose[blk].reshape(ny, SKY_BIN, nx, SKY_BIN).any(axis=(1, 3))
    # JUMP_DET grows 5 x 5 in the sky mask (``mask.PixelMask1``): at most
    # into the neighbouring bins
    hit = np.pad(hit, 1)
    hit = np.logical_or.reduce([hit[1 + dy:ny + 1 + dy, 1 + dx:nx + 1 + dx]
                                for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    k = int(hit.sum())
    gap = 0.0
    if k:
        s = np.sort(bins[np.isfinite(bins)])
        r = int(np.searchsorted(s, medsky))
        gap = float(max(s[min(r + k, len(s) - 1)] - medsky,
                        medsky - s[max(r - 1 - k, 0)], 0.0))
    rep["medsky_bound"] = 1e-4 * abs(medsky) + delta + gap
    return rep


def _spread(x):
    return float(np.percentile(x, 95) - np.percentile(x, 5))


def compare_noise(ref, got, good, what):
    """``ref``, ``got``: (nlayers, na, na) noise cubes of one exposure;
    ``good``: the (na, na) good-pixel mask.  Returns per layer the
    spreads, their ratio and the median."""
    _require(got.shape == ref.shape, f"{what}: cube {got.shape} vs {ref.shape}")
    _require(bool(np.isfinite(got).all() and np.isfinite(ref).all()),
             f"{what}: non-finite values")
    rep = []
    for j in range(ref.shape[0]):
        r, g = ref[j][good], got[j][good]
        lay = {"spread_ref": _spread(r), "spread": _spread(g),
               "median": float(np.median(g)), "median_ref": float(np.median(r))}
        lay["spread_ratio"] = lay["spread"] / lay["spread_ref"]
        _require(0.75 < lay["spread_ratio"] < 1.33 and abs(lay["median"]) < 0.3
                 and abs(lay["median_ref"]) < 0.3, f"{what}: layer {j}: {lay}")
        rep.append(lay)
    return rep


def o_tracks_signal(x, sig, good, what):
    """``x``: an 'O' layer; ``sig``: the base L2's ``data_withsky``.
    Returns the std ratio of the brightest 5% to the faintest 50%."""
    hi = good & (sig > np.percentile(sig, 95))
    lo = good & (sig < np.percentile(sig, 50))
    ratio = float(x[hi].std() / x[lo].std())
    _require(ratio > 1.5, f"{what}: 'O' std ratio bright / faint {ratio}")
    return ratio


def compare_moments(a, b, what):
    """``a``, ``b``: (nseed, ngrp, ny, nx) resultants of two samplers on
    one rate map.  Returns the largest deviations in units of sigma."""
    nseed, ngrp = a.shape[:2]
    npix = a.shape[2] * a.shape[3]
    va, vb = a.var(axis=0, ddof=1), b.var(axis=0, ddof=1)
    worst_mean = worst_var = 0.0
    for j in range(ngrp):
        dmean = (a.mean(axis=0)[j] - b.mean(axis=0)[j]).mean()
        sig = np.sqrt((va[j].mean() + vb[j].mean()) / (nseed * npix))
        # Var(s^2) = 2 sigma^4 / (n - 1) for each pixel and sampler
        v = 0.5 * (va[j].mean() + vb[j].mean())
        sig_v = v * np.sqrt(2 * 2.0 / ((nseed - 1) * npix))
        worst_mean = max(worst_mean, abs(dmean) / sig)
        worst_var = max(worst_var, abs(va[j].mean() - vb[j].mean()) / sig_v)
    rep = {"mean_dev_sigma": float(worst_mean), "var_dev_sigma": float(worst_var)}
    _require(worst_mean < 4 and worst_var < 4, f"{what}: moments differ: {rep}")
    return rep


def sim_envelope(l2, l1, expected, what):
    """``l2``, ``l1``: the ``roman`` trees of a simulated exposure (120^2
    active pixels) and its calibration; ``expected``: the scene's rate
    through the gain, DN/s.  Slope recovery and the cosmic-ray envelope
    and recall."""
    dq = np.asarray(l2["dq"])
    good = dq == 0
    x = np.where(good, np.asarray(l2["data_withsky"]) - expected, 0.0)
    xs = np.where(good, np.asarray(l2["data"]) - expected, 0.0)
    ndet = int(((dq & JUMP_DET) != 0).sum())
    truth = (np.asarray(l1["resultantdq"]) & JUMP_DET).any(axis=0)
    rep = {"good_frac": float(good.mean()), "median_resid": float(np.median(x[good])),
           "outliers_gt5": int((np.abs(x) > 5).sum()),
           "median_resid_nosky": float(np.median(xs[good])), "jump_det": ndet,
           "cr_truth_pixels": int(truth.sum()),
           "cr_recall": float(((dq & JUMP_DET) != 0)[truth].mean()) if truth.any() else 0.0}
    _require(rep["good_frac"] > 0.8 and 0.15 < rep["median_resid"] < 0.45
             and rep["outliers_gt5"] < 20 and abs(rep["median_resid_nosky"]) < 0.1,
             f"{what}: slope recovery {rep}")
    # ~14 flagged pixels expected at 120^2 (8e-6 /pix/s, 13 live reads)
    _require(2 <= ndet <= 60 and rep["cr_truth_pixels"] >= 2 and rep["cr_recall"] > 0.5,
             f"{what}: cosmic rays {rep}")
    return rep


#: the noise layers of the reference's example configuration
#: (``examples/cal_config.yaml``)
NOISE_LAYERS = ("Rz4PbrS2C1", "Rz4OS2C2")


def plain_devices(d, ref="cpu", dev="cuda", nside=128, nseed=8):
    """The port's plain path (every backend ``xla`` / ``dot``) on ``dev``
    held to the same path on ``ref``, in directory ``d``: a synthetic
    ``nside``^2 CALDIR (seed 5) and 6-group L1 (the port's ``synth``)
    through ``calibrateimage`` with the classic fit and, through the
    core with the slab route's twin, the likelihood fit, at
    :func:`compare_outputs`; the noise layers :data:`NOISE_LAYERS` of the
    classic L2 (``device-strict``, seed 15000) at :func:`compare_noise`;
    the sim's resultants over ``nseed`` seeds at
    :func:`compare_moments`, and one exposure from a 5-star scene (seed
    200) through sim -> L1 -> L2 on each device at :func:`sim_envelope`.
    On ``dev`` other library kernels run (matrix products, solves,
    reductions), so this is what holds the card's plain path, and with
    it every kernel held to that path, to the CPU's, which the CPU tests
    hold to the JAX package.  Returns what was measured, with ``bits``:
    :func:`bit_differences` of the two fits' outputs (``classic``,
    ``likely_slab_plain``), reported, not gated."""
    from .. import synth
    from ..config import pattern_to_reads
    from ..io import asdf_lite, calfiles, fits_lite
    from ..ops import ipc_slab, rand
    from ..pipeline import l1_to_l2, noise, sim_to_l1

    rp = synth.READ_PATTERN_DEFAULT
    nb = 4
    caldir = synth.make_cal_files(d + "/cal", rp, nside=nside, seed=5)
    cal = synth.synth_cal_arrays(nside, rp, seed=5)
    synth.write_l1_file(d + "/L1.asdf",
                        synth.synth_l1_cube(cal, rp, rate_dn_s=10.0, nborder=nb),
                        rp, amp33=synth.synth_amp33(nside, len(rp), nb))
    base = {"IN": d + "/L1.asdf", "CALDIR": caldir, "SKYORDER": 2, "SLICEOUT": True,
            "IPC_BACKEND": "xla", "LIN_BACKEND": "xla", "SKY_BACKEND": "xla"}
    devs = (ref, dev)
    rep = {}

    classic = {x: l1_to_l2.calibrateimage(dict(base, OUT=d + f"/L2_{i}.asdf"),
                                          device=x, return_arrays=True)
               for i, x in enumerate(devs)}
    rep["classic"] = compare_outputs(classic[ref], classic[dev],
                                     f"classic fit, {dev} vs {ref}")
    rep["bits"] = {"classic": bit_differences(classic[ref], classic[dev])}
    nz = {"LAYER": list(NOISE_LAYERS), "SEED": 15000, "BACKEND": "device-strict"}
    cubes = {x: noise.make_noise_cube(
        dict(base, OUT=d + f"/L2_{i}.asdf", NOISE=nz, PINK_BACKEND="xla",
             CONTRACT_BACKEND="dot"), device=x) for i, x in enumerate(devs)}
    rep["noise"] = compare_noise(cubes[ref], cubes[dev],
                                 classic[ref]["pdq"][nb:-nb, nb:-nb] == 0,
                                 f"noise layers, {dev} vs {ref}")

    pack = calfiles.load_caldir_cached(caldir)
    l1 = asdf_lite.open(base["IN"])["roman"]
    likely = {}
    for x in devs:
        prep = l1_to_l2.prepare_inputs(l1, dict(base, romancal_ramp_fit=True), pack,
                                       device=x)
        prep["cfg"]["ipc"] = "slab-plain"
        prep["arr"]["ipc_kernel_padded"] = l1_to_l2.stage(
            ipc_slab.kernel_planes_padded(pack.ipc_kernel, th=l1_to_l2.SLAB_TH), x)
        core = l1_to_l2.make_core(prep["plan"], prep["cfg"], prep["geom"])
        likely[x] = l1_to_l2.to_host(core(prep["arr"]))
    rep["likely_slab_plain"] = compare_outputs(
        likely[ref], likely[dev], f"likelihood fit (slab twin), {dev} vs {ref}")
    rep["bits"]["likely_slab_plain"] = bit_differences(likely[ref], likely[dev])

    na = nside - 2 * nb
    yy, xx = np.mgrid[:na, :na]
    rate = (2.0 + 10.0 * xx / na + 40.0 * np.exp(
        -0.5 * ((xx - 20) ** 2 + (yy - 30) ** 2) / 9.0)).astype(np.float32)
    res = {x: np.stack([sim_to_l1.make_l1_fullcal(
        rand.sim_generator(100 + s, x), rate, rp, pack)[0].cpu().numpy()
        for s in range(nseed)]).astype(np.float64) for x in devs}
    rep["sim_moments"] = compare_moments(res[dev], res[ref],
                                         f"sim resultants, {dev} vs {ref}")

    scene = synth.make_scene_file(d + "/truth_F184_163_4.fits", nside_active=na,
                                  nstars=5)
    truth = fits_lite.open_fits(scene)[0].data[::-1, :]  # SCA 4: vertical flip
    expected = truth / pack.gain[nb:-nb, nb:-nb] / 139.8  # the scene's exposure time
    for i, x in enumerate(devs):
        c1 = {"IN": scene, "OUT": d + f"/L1_sim_{i}.asdf", "READS": pattern_to_reads(rp),
              "CALDIR": caldir, "SEED": 200, "IPC_BACKEND": "xla",
              "LIN_BACKEND": "xla", "PINK_BACKEND": "xla", "CONTRACT_BACKEND": "dot"}
        sim_to_l1.run_config(c1, device=x)
        c2 = dict(base, IN=c1["OUT"], OUT=d + f"/L2_sim_{i}.asdf",
                  FITSWCS=c1["OUT"][:-5] + "_asdf_wcshead.txt")
        l1_to_l2.calibrateimage(c2, device=x)
        rep[f"sim_envelope_{x}"] = sim_envelope(
            asdf_lite.open(c2["OUT"])["roman"], asdf_lite.open(c1["OUT"])["roman"],
            expected, f"sim -> L1 -> L2 on {x}")
    return rep


def mc_stack(stack, min_count, what, inner=20):
    """``stack``: the (8, n, n) statistics cube of ``nrun`` realizations;
    on the pixels ``inner`` or more from the edge, those unmasked in at
    least ``min_count`` realizations ("good"): more than 80% good, the
    ramp accumulates (median last-minus-second group difference > 0),
    |median bias| < 0.3 DN/s, the median reported error over the median
    empirical std in 0.3-4.  Returns what was measured."""
    _require(bool(np.isfinite(stack).all()), f"{what}: stack not finite")
    _ideal, med_diff, _img, count, _mean, std, bias, med_err = stack
    sl = np.s_[inner:-inner, inner:-inner]
    good = count[sl] >= min_count
    rep = {"good_frac": float(good.mean()),
           "median_l1_diff": float(np.median(med_diff[sl])),
           "median_bias": float(np.median(bias[sl][good])),
           "median_std": float(np.median(std[sl][good])),
           "median_err": float(np.median(med_err[sl][good]))}
    rep["err_over_std"] = rep["median_err"] / (rep["median_std"] + 1e-9)
    _require(rep["good_frac"] > 0.8 and rep["median_l1_diff"] > 0
             and abs(rep["median_bias"]) < 0.3 and 0.3 < rep["err_over_std"] < 4.0,
             f"{what}: {rep}")
    return rep


def _strip_timing(log):
    return "".join(ln for ln in log.splitlines(keepends=True)
                   if not ln.startswith("Timing:"))


def same_tree(a, b, what, subst=None, _path="tree"):
    """Hold ``b`` to ``a`` bit for bit: dict keys, list lengths, scalar
    and string values, array dtypes, shapes and values (NaN equal to
    NaN).  ``subst``: ``(old, new)``, replaced in ``a``'s strings first
    (the output directory of each run); a ``log`` string is compared
    without its ``Timing:`` lines."""
    if isinstance(a, dict):
        _require(isinstance(b, dict) and set(a) == set(b),
                 f"{what}: {_path}: keys {sorted(a)} vs "
                 f"{sorted(b) if isinstance(b, dict) else type(b)}")
        for k in a:
            same_tree(a[k], b[k], what, subst, f"{_path}.{k}")
    elif isinstance(a, (list, tuple)):
        _require(isinstance(b, (list, tuple)) and len(a) == len(b),
                 f"{what}: {_path}: {a!r} vs {b!r}")
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, what, subst, f"{_path}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        _require(a.dtype == b.dtype and a.shape == b.shape,
                 f"{what}: {_path}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        same = (a == b) | ((a != a) & (b != b))
        _require(bool(np.all(same)), f"{what}: {_path} differs on "
                 f"{int(np.size(same) - np.count_nonzero(same))} elements")
    elif isinstance(a, str):
        if subst is not None:
            a = a.replace(*subst)
        if _path.endswith(".log"):
            a, b = _strip_timing(a), _strip_timing(str(b))
        _require(a == b, f"{what}: {_path}: {a!r} vs {b!r}")
    else:
        _require(type(a) is type(b) and (a == b or (a != a and b != b)),
                 f"{what}: {_path}: {a!r} vs {b!r}")
