"""The benchmark's plain reference of one SCA's L1 -> L2 calibration.

A frozen copy of the plain PyTorch path of the port's
``pipeline/l1_to_l2.py`` (commit 30ea5db), with what the benchmark's
comparison needs and nothing of the program: no kernel, no cache, no
file I/O, one whole frame on one device (the port's row slabs, halos
and gathers across devices are left out).  :func:`calibrate` works out
again, from the same L1 tree and cal pack as the program gets, the plan
and weights, the IPC precal of the dark and the flat, the kernel planes,
the device core, and the L2 arrays that the program's ``package_tree``
writes.  It honours the program's configuration keys in
:data:`HONOURED` and the kernel choices ``*_BACKEND`` (every kernel
gives its plain twin's answer); :func:`unhonoured` names any other.
Every float32 matrix product runs in full float32 (TF32 off) unless
:func:`.sky.lowered_precision` holds, the comparison's control.
"""

import numpy as np
import torch

from . import ipc, likely, linearity, mask, ramp, refsub, saturation, sky
from .dqflags import group as gdq
from .dqflags import i32, pixel

#: the program's configuration keys that :func:`calibrate` reads as the
#: program does (``CALDIR``, ``IN``, ``OUT``, ``FITSWCS``: the files a
#: call names)
HONOURED = frozenset((
    "CALDIR", "IN", "OUT", "FITSWCS", "EXCLUDE_FIRST", "SATURATION_BACKUP",
    "RAMP_OPT_PARS", "JUMP_DETECT_PARS", "romancal_ramp_fit", "REJECTION_THRESHOLD",
    "SKYORDER", "SLICEOUT",
))


def unhonoured(config):
    """The keys of the program's ``config`` that the reference does not
    honour, sorted: keys outside :data:`HONOURED` that do not name a
    kernel choice (``*_BACKEND``)."""
    return sorted(k for k in config if k not in HONOURED and not k.endswith("_BACKEND"))


PRODUCT_OUTPUTS = (
    "slope", "slope_withsky", "slope_err_read", "slope_err_poisson",
    "pdq", "medsky", "skycoefs", "endslice",
)


class _Frame:
    """One frame's state through the stages: the staged arrays ``arr``
    and the state tensors (``data``, ``rdq``, ``pdq``, then the fit's)."""

    def __init__(self, arr, nside, nb):
        self.arr, self.nside, self.nb = arr, nside, nb
        self.data = arr["data"]
        self.dev = self.data.device
        self.act = (slice(nb, nside - nb), slice(nb, nside - nb))

    def interior(self):
        """The frame's interior (by nborder)."""
        m = torch.zeros((self.nside, self.nside), dtype=torch.bool, device=self.dev)
        m[self.act] = True
        return m


def _add_active(x, y, act):
    """A copy of the 2-D ``x`` with ``y`` added on ``x[act]``."""
    out = x.clone()
    out[act] += y
    return out


def _saturation(s, cfg):
    """dq initialization (romancal do_dqinit analog) and saturation."""
    s.pdq = s.arr["mask_dq"]
    s.rdq = torch.zeros(s.data.shape, dtype=torch.int32, device=s.dev)
    if cfg["exclude_first"]:
        s.rdq[0] |= i32(gdq.DO_NOT_USE)
    s.rdq, s.pdq = saturation.flag_saturation(
        s.data, s.rdq, s.pdq, s.arr["saturation"], s.arr["saturation_dq"],
        backup=cfg["backup"], skip_first=1, n_pix_grow_sat=1,
    )


def _refpix(s, cfg, geom):
    """Per-group reference-pixel correction (reference
    ``gen_cal_image.py:531-556``): dark-subtracted frame (+ amp33
    reference block), row subtraction with the optimal amp33 slope,
    then channel subtraction; dark re-added afterwards.  All groups at
    once."""
    nside, nb, channelwidth = geom
    dark = s.arr["dark_cube"]
    work = s.data - dark
    # ---- row stage (reference_subtraction.py:77-125) ----
    if cfg["use_amp33"]:
        amp33 = s.arr["amp33"]
        ngrp = amp33.shape[0]
        blk = amp33 - s.arr["amp33_med"]
        blk = blk - refsub.median(blk.reshape(ngrp, -1), dim=-1)[:, None, None]
        ref_med = refsub.median(blk, dim=-1)  # (ngrp, nside)
        ctr = refsub.median(ref_med, dim=-1)[:, None]
        work = work - (s.arr["opt_slope"] * (ref_med - ctr))[..., None]
    else:
        sci_med, ref_med = refsub.row_medians(work, nside, nb)
        m, ctr = refsub.row_coefs(sci_med, ref_med)
        work = refsub.row_apply(work, ref_med, m, ctr)
    # ---- channel stage (reference_subtraction.py:16-74) ----
    m, c = refsub.channel_line(work[..., :nb, :], work[..., nside - nb:, :],
                               nside, nside, nb, channelwidth)
    s.data = refsub.channel_apply(work, m, c, channelwidth, row0=0) + dark


def _linearity(s, cfg):
    a = s.arr
    lin = linearity.LinearityData(a["lin_coefs"], a["lin_smin"], a["lin_smax"],
                                  a["lin_sref"], a["lin_dq"])
    attempt = (s.rdq & i32(gdq.SATURATED)) == 0
    s.data, dq_lin = linearity.apply_linearity_cube(
        s.data, lin, do_not_flag_first=cfg["first_is_reset"], attempt_corr=attempt)
    s.pdq = s.pdq | dq_lin


def _ipc(s):
    """Order-2 inverse on the active region, the border passed through."""
    nside = s.nside
    res = ipc.ipc_rev(s.data.contiguous(), s.arr["ipc_kernel_frame"].view(3, 3, nside, nside),
                      order=2, gain=s.arr["gain"])
    s.data = torch.where(s.interior(), res, s.data)


def kernel_planes_frame(kernel, nside, nborder=4):
    """(9, nside, nside) float32 kernel planes, border zero: plane
    ``3 * (1 + dy) + (1 + dx)`` holds ``kernel[1 + dy, 1 + dx]``."""
    na = kernel.shape[-1]
    kp = np.zeros((9, nside, nside), np.float32)
    kp[:, nborder : nborder + na, nborder : nborder + na] = np.asarray(
        kernel, np.float32
    ).reshape(9, na, na)
    return kp


def _ramp(s, plan, cfg):
    fit = likely.ramp_fit_likely if cfg["likelihood_fit"] else ramp.ramp_fit
    if sky.lowered():
        s.data = s.data.to(torch.bfloat16).to(torch.float32)
    res = fit(s.data, s.rdq, s.pdq, plan, s.arr["gain"], s.arr["read_sigma"],
              nborder=s.nb, interior=s.interior())
    s.slope, s.ser, s.sep, s.rdq, s.pdq = res[:5]
    s.dumo, s.chisq = res[5:] if cfg["likelihood_fit"] else (None, None)


def _dark_flat(s, cfg, has_ipc):
    """Dark current (IPC-corrected dark slope), border zeroing, flat
    field (reference flatutils.get_flat + area factor)."""
    act, a = s.act, s.arr
    zero = torch.zeros((), dtype=torch.int32, device=s.dev)
    if has_ipc:
        s.slope = _add_active(s.slope, -a["dark_slope_ipc"], act)
    else:
        s.slope = _add_active(s.slope, -a["dark_slope"][act], act)
    if cfg["has_dark_dq"]:
        s.pdq = s.pdq | a["dark_dq"]

    # zero the border of the science/variance maps (reference
    # do_ramp_fit re-embedding, gen_cal_image.py:470-475)
    interior = s.interior()
    fzero = torch.zeros((), dtype=torch.float32, device=s.dev)
    s.slope = torch.where(interior, s.slope, fzero)
    s.ser = torch.where(interior, s.ser, fzero)
    s.sep = torch.where(interior, s.sep, fzero)

    flat = torch.ones((s.nside, s.nside), dtype=torch.float32, device=s.dev)
    flat[act] = a["flat"][act]
    s.pdq = s.pdq | torch.where((flat < 0.1) | (flat > 10.0),
                                i32(pixel.NO_FLAT_FIELD), zero)
    flat = torch.clamp(flat, 0.1, 10.0)
    if has_ipc:
        no_gain = torch.zeros((s.nside, s.nside), dtype=torch.bool, device=s.dev)
        no_gain[act] = a["gain"][act] <= 0.1
        s.pdq = s.pdq | torch.where(no_gain, i32(pixel.NO_GAIN_VALUE), zero)
        flat[act] = a["flat_ipc"]
    s.flat = flat / a["area_factor"]
    s.slope = s.slope / s.flat
    s.ser = s.ser / s.flat
    s.sep = s.sep / s.flat


def _sky(s, cfg):
    """Sky mode (PixelMask1, 4 x 4 bins) and the medfit Legendre sky.
    Returns (medsky, skycoefs)."""
    s.slope_withsky = s.slope
    m = mask.PixelMask1.build(s.pdq)
    nan = torch.full((), float("nan"), dtype=torch.float32, device=s.dev)
    medsky, _ = sky.smooth_mode(sky.binkxk(torch.where(~m, s.slope, nan), 4))
    if cfg["skyorder"] >= 0:
        skycoefs, skymodel = sky.medfit(s.slope[s.act], order=cfg["skyorder"])
        s.slope = _add_active(s.slope, -skymodel, s.act)
    else:
        skycoefs = torch.zeros(0, dtype=torch.float32, device=s.dev)
    return medsky, skycoefs


def core(arr, plan, cfg, geom):
    """The calibration core on the whole frame: the staged array bundle
    to a dict of device tensors (:data:`PRODUCT_OUTPUTS`, and ``dumo``,
    ``chisq`` after the likelihood fit)."""
    nside, nb, _ = geom
    s = _Frame(arr, nside, nb)
    ngrp = s.data.shape[0]
    _saturation(s, cfg)
    _refpix(s, cfg, geom)
    if cfg["has_biascorr"]:
        s.data = s.data.clone()
        s.data[(slice(None),) + s.act] -= arr["biascorr"]
    _linearity(s, cfg)
    if cfg["has_ipc"]:
        _ipc(s)
    _ramp(s, plan, cfg)
    _dark_flat(s, cfg, cfg["has_ipc"])
    medsky, skycoefs = _sky(s, cfg)
    firstsat = ramp.first_saturated_group(s.rdq)[s.act]
    out = {
        "slope": s.slope,
        "slope_withsky": s.slope_withsky,
        "slope_err_read": s.ser,
        "slope_err_poisson": s.sep,
        "pdq": s.pdq,
        "medsky": medsky,
        "skycoefs": skycoefs,
        "endslice": torch.where(
            firstsat < ngrp, firstsat - 1, torch.full_like(firstsat, -1)
        ).to(torch.int8),
    }
    if s.dumo is not None:
        # dumo is slope-like -> flat-field it (gen_cal_image.py:671)
        out["dumo"] = s.dumo / s.flat
        out["chisq"] = s.chisq
    return out


def _to_host(out):
    """Core outputs -> numpy (DQ planes as uint32)."""
    host = {}
    for k, v in out.items():
        a = v.detach().cpu().numpy()
        host[k] = a.view(np.uint32) if k in ("pdq", "rdq") else a
    return host


def _put(a, device):
    """A host numpy array as a tensor on ``device`` (uint32 DQ arrays as
    int32 bit patterns, uint16 counts widened to int32)."""
    arr = np.ascontiguousarray(a)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32)).to(device)
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.astype(np.int32)).to(device)
    return torch.from_numpy(np.asarray(arr, np.float32)).to(device)


def ipc_precal(flat, dark_slope, gain, ipc_kernel, nborder, device):
    """IPC-deconvolved dark-slope and clipped-flat planes, active region:
    unclipped gain for the dark slope, gain clipped to >= 0.1 for the
    flat (reference ``gen_cal_image.py:217-221``, ``flatutils.py:61-74``)."""
    nb = nborder
    gain_act = np.asarray(gain[nb:-nb, nb:-nb], np.float32)
    gain_flat = np.clip(gain_act, 0.1, None)
    flat_clipped = np.clip(np.asarray(flat[nb:-nb, nb:-nb], np.float32), 0.1, 10.0)
    dslope_act = np.asarray(dark_slope[nb:-nb, nb:-nb], np.float32)
    stacked = np.stack([dslope_act * gain_act, flat_clipped * gain_flat])
    corr = ipc.ipc_rev(torch.from_numpy(stacked).to(device), _put(ipc_kernel, device))
    return (corr[0] / torch.from_numpy(gain_act).to(device),
            corr[1] / torch.from_numpy(gain_flat).to(device))


def amp33_optimal_slope(pack):
    """Optimal row-reference coupling slope from the pink-noise model
    (reference ``gen_cal_image.py:542-553``); None without amp33."""
    if not pack.amp33_valid:
        return None
    cvar = pack.c_pink**2
    m = pack.amp33_m_pink
    nside, cw = pack.amp33_med.shape
    return float(m * cvar / (m * m * cvar + pack.amp33_ru_pink**2
                             + np.median(pack.amp33_std) ** 2 / cw / np.log(nside)))


def prepare(l1, config, pack, area_factor, device):
    """The plan, the static choices and the array bundle on ``device``:
    the port's ``prepare_inputs`` without the guide window, dark decay
    and WFI18 inputs (ValueError where a key or the cal pack asks for
    them)."""
    if unhonoured(config):
        raise ValueError(f"the reference does not honour {unhonoured(config)}")
    caldir = config["CALDIR"]
    if "dark_decay" in caldir or "guide_star" in l1["meta"]:
        raise ValueError("the reference does not cover dark decay or a guide window")
    nside = pack.nside
    nb = 4
    data = np.asarray(l1["data"])
    ngrp = data.shape[0]
    read_pattern = [list(g) for g in l1["meta"]["exposure"]["read_pattern"]]
    frame_time = float(l1["meta"]["exposure"].get("frame_time", 3.04))
    channelwidth = np.asarray(l1["amp33"]).shape[-1]
    meta = ramp.ma_table_meta(read_pattern, frame_time)
    meta["nborder"] = nb
    exclude_first = bool(config.get("EXCLUDE_FIRST", True))
    uopt = config.get("RAMP_OPT_PARS", {"slope": 0.4, "gain": 1.8, "sigma_read": 6.5})
    u_ = float(uopt["slope"]) / float(uopt["gain"]) / float(uopt["sigma_read"]) ** 2
    likelihood_fit = bool(config.get("romancal_ramp_fit", False))
    if likelihood_fit:
        plan = likely.build_likely_plan(
            meta, exclude_first,
            rejection_threshold=float(config.get("REJECTION_THRESHOLD", 4.5)))
    else:
        plan = ramp.build_plan(meta, u_, exclude_first, config.get("JUMP_DETECT_PARS"))
    use_amp33 = pack.amp33_valid and "amp33" in l1
    opt_slope = amp33_optimal_slope(pack) if use_amp33 else None
    cfg = dict(
        exclude_first=exclude_first,
        backup=int(config.get("SATURATION_BACKUP", 1)),
        use_amp33=bool(use_amp33),
        likelihood_fit=likelihood_fit,
        has_biascorr="biascorr" in caldir,
        first_is_reset=(read_pattern[0] == [0]),
        has_ipc="ipc4d" in caldir,
        has_dark_dq=pack.dark_dq is not None,
        skyorder=int(config.get("SKYORDER", -1)),
    )
    de = pack.dark_cube.shape[0] - ngrp
    zeros = np.zeros((nside, nside), np.uint32)
    host = {
        "data": data,
        "amp33": l1["amp33"],
        "amp33_med": pack.amp33_med,
        "dark_cube": pack.dark_cube[de:],
        "dark_slope": pack.dark_slope,
        "dark_dq": pack.dark_dq if pack.dark_dq is not None else zeros,
        "gain": pack.gain,
        "read_sigma": pack.read_sigma,
        "mask_dq": pack.mask_dq if pack.mask_dq is not None else zeros,
        "saturation": pack.saturation,
        "saturation_dq": pack.saturation_dq if pack.saturation_dq is not None else zeros,
        "biascorr": pack.biascorr[pack.biascorr.shape[0] - ngrp:],
        "lin_coefs": pack.lin_coefs,
        "lin_smin": pack.lin_smin,
        "lin_smax": pack.lin_smax,
        "lin_sref": pack.lin_sref,
        "lin_dq": pack.lin_dq,
        "flat": pack.flat,
        "area_factor": area_factor,
    }
    arr = {k: _put(v, device) for k, v in host.items()}
    arr["data"] = arr["data"].to(torch.float32)
    arr["amp33"] = arr["amp33"].to(torch.float32)
    arr["opt_slope"] = torch.tensor(
        float(np.float32(opt_slope if opt_slope is not None else 0.0)),
        dtype=torch.float32, device=device)
    if cfg["has_ipc"]:
        arr["dark_slope_ipc"], arr["flat_ipc"] = ipc_precal(
            pack.flat, pack.dark_slope, pack.gain, pack.ipc_kernel, nb, device)
        arr["ipc_kernel_frame"] = _put(kernel_planes_frame(pack.ipc_kernel, nside, nb),
                                       device)
    return arr, plan, cfg, (nside, nb, int(channelwidth))


def calibrate(l1, config, pack, area_factor, device):
    """The L2 arrays that the program's packaging writes, worked out from
    the L1 tree, the cal pack and the area map: ``data``, ``dq``,
    ``err``, ``var_poisson``, ``var_rnoise``, ``data_withsky``, the
    border reference pixels and their DQ, ``amp33``, ``dumo`` and
    ``chisq`` (likelihood fit), and ``medsky``, ``skycoefs``, and with
    ``SLICEOUT`` ``endslice``."""
    arr, plan, cfg, geom = prepare(l1, config, pack, area_factor, device)
    out = _to_host(core(arr, plan, cfg, geom))
    del arr
    nside, nb, _ = geom
    act = slice(nb, nside - nb)
    ser, sep, pdq = out["slope_err_read"], out["slope_err_poisson"], out["pdq"]
    data = np.asarray(l1["data"])
    res = {
        "data": np.asarray(out["slope"][act, act], np.float32),
        "dq": np.asarray(pdq[act, act], np.uint32),
        "err": np.hypot(ser, sep).astype(np.float32)[act, act],
        "var_poisson": np.asarray(sep[act, act] ** 2, np.float32),
        "var_rnoise": np.asarray(ser[act, act] ** 2, np.float32),
        "data_withsky": np.asarray(out["slope_withsky"][act, act], np.float32),
        "amp33": np.asarray(l1["amp33"]),
        "border_ref_pix_left": data[:, :, :nb].astype(np.float32),
        "border_ref_pix_right": data[:, :, nside - nb:].astype(np.float32),
        "border_ref_pix_top": data[:, nside - nb:, :].astype(np.float32),
        "border_ref_pix_bottom": data[:, :nb, :].astype(np.float32),
        "dq_border_ref_pix_left": np.asarray(pdq[:, :nb], np.uint32),
        "dq_border_ref_pix_right": np.asarray(pdq[:, nside - nb:], np.uint32),
        "dq_border_ref_pix_top": np.asarray(pdq[nside - nb:, :], np.uint32),
        "dq_border_ref_pix_bottom": np.asarray(pdq[:nb, :], np.uint32),
        "medsky": np.float64(float(out["medsky"])),
        "skycoefs": np.asarray(out["skycoefs"], np.float32),
    }
    if config.get("SLICEOUT", False):
        res["endslice"] = np.asarray(out["endslice"], np.int8)
    if "dumo" in out:
        res["dumo"] = np.asarray(out["dumo"][act, act], np.float16)
        res["chisq"] = np.asarray(out["chisq"][act, act], np.float16)
    return res
