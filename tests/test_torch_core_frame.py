"""The single-SCA calibration core against the whole-frame closure it
was factored from, bit for bit, on the CPU.

``l1_to_l2.make_core`` runs the stage functions of
``l1_to_l2.calibrate_rows`` on one part, the whole frame (the
row-sharded core of ``parallel.spatial`` runs the same functions on row
slabs).  Before the stages took a row context, the core was one closure
over the whole frame; :func:`_frame_core` below is that closure, with
the whole-frame forms of the helpers it called (the reference-pixel row
and channel subtractions, the IPC inverses' plain twins) kept beside it,
so that it shares with the code under test only the ops modules that the
factoring left as they were (saturation, linearity, ramp fits, mask,
sky).  Every output of ``make_core``, the diagnostics ``rdq`` and
``flat`` included, must have the closure's bits: same dtype, same shape,
equal bit patterns (NaN at the same places).  64^2 bundles of
``benchlib.core_bundle``, each stage switched on in one case or another
(amp33 or border-column row fit, bias correction, dark decay, dark DQ,
the likelihood fit, the frame and the slab IPC routes' twins, the
ablations), and a 128^2 WFI18 L1 through ``prepare_inputs``.
"""

import numpy as np
import pytest
import torch

from romanimpreprocess_tpu_torch import benchlib, synth
from romanimpreprocess_tpu_torch.config import pattern_to_reads
from romanimpreprocess_tpu_torch.dqflags import group as gdq
from romanimpreprocess_tpu_torch.dqflags import i32, pixel
from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles
from romanimpreprocess_tpu_torch.ops import (ipc, ipc_slab, likely, linearity, mask, ramp,
                                             saturation, sky)
from romanimpreprocess_tpu_torch.ops.refsub import median
from romanimpreprocess_tpu_torch.ops.sky import full_fp32
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, sim_to_l1

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# the whole-frame closure and its whole-frame helpers
# --------------------------------------------------------------------------

def _ref_row(image, nside, nborder):
    """Row subtraction from the border columns over the whole frame."""
    nb = nborder
    sci_med = median(image[..., nb : nside - nb], dim=-1)
    ref = torch.cat([image[..., :nb], image[..., nside - nb : nside]], dim=-1)
    ref_med = median(ref, dim=-1)
    rm = ref_med.mean(dim=-1, keepdim=True)
    sm = sci_med.mean(dim=-1, keepdim=True)
    m = ((ref_med - rm) * (sci_med - sm)).sum(dim=-1, keepdim=True) / (
        (ref_med - rm) ** 2
    ).sum(dim=-1, keepdim=True)
    ctr = median(ref_med, dim=-1)[..., None]
    return image - (m * (ref_med - ctr))[..., None]


def _ref_channel(image, nside, nborder, channelwidth):
    """Channel lines from the frame's bottom and top rows."""
    ny, nxa = image.shape[-2:]
    lead = image.shape[:-2]
    nch = min(nxa // channelwidth, nside // channelwidth)
    nb = nborder
    block = image[..., : nch * channelwidth].reshape(lead + (ny, nch, channelwidth))

    def edge_median(rows):
        r = rows.transpose(-3, -2).reshape(lead + (nch, nb * channelwidth))
        return median(r, dim=-1)

    bottom = edge_median(block[..., :nb, :, :])
    top = edge_median(block[..., ny - nb :, :, :])
    y0 = (nb - 1) / 2.0
    y1 = ny - 1 - (nb - 1) / 2.0
    m = (top - bottom) / (y1 - y0)
    c = bottom - m * y0
    rows = torch.arange(ny, dtype=image.dtype, device=image.device)
    correction = m[..., None, :] * rows[:, None] + c[..., None, :]
    block = block - correction[..., None]
    out = image.clone()
    out[..., : nch * channelwidth] = block.reshape(lead + (ny, nch * channelwidth))
    return out


def _refpix(data, arr, nside, nb, channelwidth, use_amp33):
    ngrp = data.shape[0]
    work = data - arr["dark_cube"]
    if use_amp33:
        blk = arr["amp33"] - arr["amp33_med"]
        blk = blk - median(blk.reshape(ngrp, -1), dim=-1)[:, None, None]
        ref_med = median(blk, dim=-1)
        ctr = median(ref_med, dim=-1)[:, None]
        work = work - (arr["opt_slope"] * (ref_med - ctr))[..., None]
    else:
        work = _ref_row(work, nside, nb)
    work = _ref_channel(work, nside, nb, channelwidth)
    return work + arr["dark_cube"]


def _wfi18(data, basis, nside, nb):
    prof = median(data[0, :, nb : nside - nb] - data[1, :, nb : nside - nb], dim=-1)
    prof = prof - median(prof)
    with full_fp32():
        coef = torch.linalg.solve(basis.T @ basis, basis.T @ prof)
        model = basis @ coef
    out = data.clone()
    out[0] -= model[:, None]
    return out


def _ipc_frame(data, planes, gain, nb):
    """The frame route's twin: the Neumann inverse on the whole frame."""
    nside = data.shape[-1]
    res = ipc.ipc_rev(data, planes.view(3, 3, nside, nside), order=2, gain=gain)
    act = torch.zeros((nside, nside), dtype=torch.bool)
    act[nb : nside - nb, nb : nside - nb] = True
    return torch.where(act, res, data)


def _ipc_slab(data, kernel_padded, gain, nb, th):
    """The slab routes' twin: the slab order on the active slice."""
    ny = data.shape[-2]
    na = ny - 2 * nb
    planes = kernel_padded[:, th : th + na, 2 : 2 + na]
    out = data.clone()
    out[:, nb : ny - nb, nb : ny - nb] = ipc_slab.ipc_rev2_plain(
        data[:, nb : ny - nb, nb : ny - nb], planes, gain)
    return out


def _add_active(x, y, nb):
    out = x.clone()
    out[nb : x.shape[-2] - nb, nb : x.shape[-1] - nb] += y
    return out


def _frame_core(plan, cfg, geom):
    """The calibration core as one closure over the whole frame."""
    nside, nb, channelwidth = geom
    act = (slice(nb, nside - nb), slice(nb, nside - nb))
    ab = cfg.get("ablate", ())
    has_ipc = cfg["has_ipc"] and "ipc" not in ab

    def core(arr):
        data = arr["data"]
        ngrp = data.shape[0]
        zero = torch.zeros((), dtype=torch.int32)
        pdq = arr["mask_dq"]
        rdq = torch.zeros(data.shape, dtype=torch.int32)
        if cfg["exclude_first"]:
            rdq[0] |= i32(gdq.DO_NOT_USE)
        if "saturation" not in ab:
            rdq, pdq = saturation.flag_saturation(
                data, rdq, pdq, arr["saturation"], arr["saturation_dq"],
                backup=cfg["backup"], skip_first=1, n_pix_grow_sat=1)
        if "refpix" not in ab:
            data = _refpix(data, arr, nside, nb, channelwidth, cfg["use_amp33"])
        if cfg["has_biascorr"]:
            data = data.clone()
            data[:, act[0], act[1]] -= arr["biascorr"]
        if cfg["has_dark_decay"]:
            data = data - arr["dark_decay_signal"][:, None, None]
        if cfg["wfi18"]:
            data = _wfi18(data, arr["wfi18_basis"], nside, nb)
        if "linearity" not in ab:
            lin = linearity.LinearityData(arr["lin_coefs"], arr["lin_smin"],
                                          arr["lin_smax"], arr["lin_sref"], arr["lin_dq"])
            attempt = (rdq & i32(gdq.SATURATED)) == 0
            data, dq_lin = linearity.apply_linearity_cube(
                data, lin, do_not_flag_first=cfg["first_is_reset"], attempt_corr=attempt)
            pdq = pdq | dq_lin
        if has_ipc and cfg["ipc"] == "slab-plain":
            data = _ipc_slab(data, arr["ipc_kernel_padded"], arr["gain"][act], nb,
                             l1_to_l2.SLAB_TH)
        elif has_ipc:
            data = _ipc_frame(data, arr["ipc_kernel_frame"], arr["gain"], nb)
        dumo = chisq = None
        if cfg["likelihood_fit"]:
            slope, ser, sep, rdq, pdq, dumo, chisq = likely.ramp_fit_likely(
                data, rdq, pdq, plan, arr["gain"], arr["read_sigma"], nborder=nb)
        else:
            slope, ser, sep, rdq, pdq = ramp.ramp_fit(
                data, rdq, pdq, plan, arr["gain"], arr["read_sigma"], nborder=nb)
        if has_ipc:
            slope = _add_active(slope, -arr["dark_slope_ipc"], nb)
        else:
            slope = _add_active(slope, -arr["dark_slope"][act], nb)
        if cfg["has_dark_dq"]:
            pdq = pdq | arr["dark_dq"]
        interior = torch.zeros((nside, nside), dtype=torch.bool)
        interior[act] = True
        fzero = torch.zeros((), dtype=torch.float32)
        slope = torch.where(interior, slope, fzero)
        ser = torch.where(interior, ser, fzero)
        sep = torch.where(interior, sep, fzero)
        flat = torch.ones((nside, nside), dtype=torch.float32)
        flat[act] = arr["flat"][act]
        pdq = pdq | torch.where((flat < 0.1) | (flat > 10.0), i32(pixel.NO_FLAT_FIELD), zero)
        flat = torch.clamp(flat, 0.1, 10.0)
        if has_ipc:
            no_gain = torch.zeros((nside, nside), dtype=torch.bool)
            no_gain[act] = arr["gain"][act] <= 0.1
            pdq = pdq | torch.where(no_gain, i32(pixel.NO_GAIN_VALUE), zero)
            flat[act] = arr["flat_ipc"]
        flat = flat / arr["area_factor"]
        slope, ser, sep = slope / flat, ser / flat, sep / flat
        slope_withsky = slope
        if "sky" not in ab and "smooth" not in ab:
            m = mask.PixelMask1.build(pdq)
            medsky, _ = sky.smooth_mode(
                sky.binkxk(torch.where(~m, slope, torch.tensor(float("nan"))), 4))
        else:
            medsky = torch.zeros((), dtype=torch.float32)
        if cfg["skyorder"] >= 0 and "sky" not in ab and "medfit" not in ab:
            skycoefs, skymodel = sky.medfit(slope[act], order=cfg["skyorder"],
                                            backend=cfg["med"])
            slope = _add_active(slope, -skymodel, nb)
        else:
            skycoefs = torch.zeros(0, dtype=torch.float32)
        firstsat = ramp.first_saturated_group(rdq)[act]
        endslice = torch.where(firstsat < ngrp, firstsat - 1,
                               torch.full_like(firstsat, -1)).to(torch.int8)
        out = {"slope": slope, "slope_withsky": slope_withsky, "slope_err_read": ser,
               "slope_err_poisson": sep, "pdq": pdq, "rdq": rdq, "flat": flat,
               "medsky": medsky, "skycoefs": skycoefs, "endslice": endslice}
        if dumo is not None:
            out["dumo"] = dumo / flat
            out["chisq"] = chisq
        return out

    return core


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------

def _same_bits(a, b):
    """Same dtype and shape, equal bit patterns, NaN at the same places."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = torch.where(nan, 0, a), torch.where(nan, 0, b)
    return torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                       b.reshape(-1).contiguous().view(torch.uint8))


def _hold(plan, cfg, geom, arr):
    keys = l1_to_l2.PRODUCT_OUTPUTS + ("rdq", "flat")
    if cfg["likelihood_fit"]:
        keys += ("dumo", "chisq")
    got = l1_to_l2.make_core(plan, dict(cfg, outputs=keys), geom)(arr)
    want = _frame_core(plan, cfg, geom)(arr)
    assert set(got) == set(keys)
    bad = [k for k in keys if not _same_bits(got[k], want[k])]
    assert not bad, f"outputs differing from the whole-frame closure: {bad}"


def _bundle(likelihood=False, seed=1000):
    arr, plan, cfg, geom = benchlib.core_bundle(nside=64, likelihood=likelihood, seed=seed,
                                                device="cpu")
    rng = np.random.default_rng(seed)
    ngrp, na = arr["data"].shape[0], geom[0] - 2 * geom[1]
    arr = dict(arr,
               biascorr=torch.from_numpy(rng.normal(0, 3, (ngrp, na, na)).astype(np.float32)),
               dark_decay_signal=torch.from_numpy(rng.normal(0, 2, ngrp).astype(np.float32)),
               dark_dq=torch.from_numpy(
                   np.where(rng.random((64, 64)) < 0.02, 1 << 9, 0).astype(np.int32)))
    return arr, plan, cfg, geom


# (likelihood, cfg changes) per case
CASES = {
    "classic": (False, {}),
    "likelihood": (True, {}),
    "border_row_fit": (False, {"use_amp33": False}),
    "bias_decay_darkdq": (False, {"has_biascorr": True, "has_dark_decay": True,
                                  "has_dark_dq": True}),
    "likelihood_border_row_fit_bias": (True, {"use_amp33": False, "has_biascorr": True}),
    "no_ipc_no_sky_fit": (False, {"has_ipc": False, "skyorder": -1}),
    "ablate_saturation_refpix": (False, {"ablate": ("saturation", "refpix")}),
    "ablate_linearity_ipc_smooth": (True, {"ablate": ("linearity", "ipc", "smooth")}),
    "no_exclude_first_order_1": (False, {"exclude_first": False, "skyorder": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_core_matches_whole_frame_closure(case):
    likelihood, changes = CASES[case]
    arr, plan, cfg, geom = _bundle(likelihood)
    _hold(plan, dict(cfg, **changes), geom, arr)


@pytest.mark.parametrize("likelihood", [False, True])
def test_make_core_matches_whole_frame_closure_slab_route(likelihood):
    """The slab IPC routes' twin (``cfg["ipc"] = "slab-plain"``)."""
    arr, plan, cfg, geom = _bundle(likelihood, seed=1200)
    nb, na = geom[1], geom[0] - 2 * geom[1]
    kernel = arr["ipc_kernel_frame"][:, nb:-nb, nb:-nb].reshape(3, 3, na, na).numpy()
    arr["ipc_kernel_padded"] = torch.from_numpy(
        ipc_slab.kernel_planes_padded(kernel, th=l1_to_l2.SLAB_TH))
    _hold(plan, dict(cfg, ipc="slab-plain", has_biascorr=True), geom, arr)


@pytest.mark.parametrize("likelihood", [False, True])
def test_make_core_matches_whole_frame_closure_wfi18(tmp_path, likelihood):
    """A 128^2 L1 simulated from a star scene, relabelled WFI18 (the
    transient row fit runs), through ``prepare_inputs`` on its synthetic
    CALDIR."""
    rp = [[0], [1, 2], [3, 4, 5], [6, 7, 8], [9, 10]]
    d = str(tmp_path)
    scene = synth.make_scene_file(d + "/truth_F184_163_4.fits", nside_active=120, nstars=3)
    caldir = synth.make_cal_files(d + "/roman_wfi", rp, nside=128, seed=5)
    sim_to_l1.run_config({"IN": scene, "OUT": d + "/L1.asdf", "READS": pattern_to_reads(rp),
                          "CALDIR": caldir, "SEED": 200}, device="cpu")
    f = asdf_lite.open(d + "/L1.asdf")
    tree = dict(f.tree)
    tree["roman"] = dict(tree["roman"])
    tree["roman"]["meta"] = dict(tree["roman"]["meta"])
    tree["roman"]["meta"]["instrument"] = dict(tree["roman"]["meta"]["instrument"],
                                               detector="WFI18")
    asdf_lite.AsdfFile(tree).write_to(d + "/L1_18.asdf")
    config = {"IN": d + "/L1_18.asdf", "FITSWCS": d + "/L1_asdf_wcshead.txt",
              "CALDIR": caldir, "SKYORDER": 2, "SLICEOUT": True,
              "correct_wfi18_transient": True, "romancal_ramp_fit": likelihood}
    pack = calfiles.load_caldir_cached(caldir)
    l1 = asdf_lite.open(config["IN"])["roman"]
    area = l1_to_l2.area_factor_from_config(config, pack.nside)
    prep = l1_to_l2.prepare_inputs(l1, config, pack, area, device="cpu")
    assert prep["cfg"]["wfi18"]
    _hold(prep["plan"], prep["cfg"], prep["geom"], prep["arr"])
