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
  and ``medsky`` within rtol 1e-4; ``endslice`` exact; ``dumo`` and
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
                    outside_frac=0.0, gate_sky=True):
    """Hold the outputs ``got`` to ``ref``; returns what was measured
    (largest differences, shares outside, bit equality).

    ``maps``: the float maps held to rtol 1e-5 + ``atol_frac`` max|ref|
    on all but ``outside_frac`` of the pixels; ``loose_bits``: the DQ
    bits that may differ (on at most 1e-4 of the pixels); ``gate_sky``:
    False reports ``skycoefs`` and ``medsky`` without gating them.
    """
    _require(set(got) == set(ref), f"{what}: outputs {sorted(got)} vs {sorted(ref)}")
    diff = ref["pdq"] ^ got["pdq"]
    _require(not (diff & ~np.uint32(loose_bits)).any(),
             f"{what}: DQ differs beyond bits {loose_bits}")
    jump = diff != 0
    rep = {"jump_det_diff_frac": float(jump.mean())}
    _require(rep["jump_det_diff_frac"] <= 1e-4,
             f"{what}: JUMP_DET differs on {rep['jump_det_diff_frac']} of pixels")
    for k in maps:
        r, g = ref[k], got[k]
        scale = float(np.abs(r).max())
        ok = np.abs(g - r) <= 1e-5 * np.abs(r) + atol_frac * scale
        rep[k + "_max_abs_err"] = float(np.abs(g - r).max())
        rep[k + "_outside_frac"] = float(1.0 - (ok | jump).mean())
        _require(rep[k + "_outside_frac"] <= outside_frac,
                 f"{what}: {k} differs on {rep[k + '_outside_frac']} of pixels "
                 f"(largest {rep[k + '_max_abs_err']} of {scale})")
    sr, sg = ref["skycoefs"], got["skycoefs"]
    rep["skycoefs_max_abs_err"] = float(np.abs(sg - sr).max(initial=0.0))
    rep["skycoefs_max_abs"] = float(np.abs(sr).max(initial=0.0))
    rep["skycoefs_within_gate"] = bool(
        np.allclose(sg, sr, rtol=1e-4, atol=1e-4 * rep["skycoefs_max_abs"]))
    _require(rep["skycoefs_within_gate"] or not gate_sky,
             f"{what}: skycoefs {sg} vs {sr}")
    rep["medsky_within_gate"] = bool(np.allclose(got["medsky"], ref["medsky"], rtol=1e-4))
    _require(rep["medsky_within_gate"] or not gate_sky,
             f"{what}: medsky {got['medsky']} vs {ref['medsky']}")
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
    hold to the JAX package.  Returns what was measured."""
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
              "PINK_BACKEND": "xla", "CONTRACT_BACKEND": "dot"}
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
