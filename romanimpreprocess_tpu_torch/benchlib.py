"""In-memory synthetic inputs for the calibration core and the exposure
runner (no file I/O, no disk cache).

The detector model of :mod:`.synth` (``synth_cal_arrays``,
``synth_l1_cube``) packaged as the staged bundles that
:func:`.pipeline.l1_to_l2.make_core` and the staged runners of
:mod:`.pipeline.noise_core` consume, on ``device`` (default ``cuda``;
raises without a GPU).  The IPC kernel is staged in the form the
resolved ``IPC_BACKEND`` route reads (the frame planes, or the slab
kernel's padded planes).
"""

import numpy as np
import torch

from .config import resolve_device, resolve_kernels
from .io import staging
from .io.calfiles import CalPack
from .ops import ipc_cuda, ipc_slab, likely, ramp
from .pipeline import l1_to_l2, noise_core
from .synth import READ_PATTERN_DEFAULT, synth_cal_arrays, synth_l1_cube


def core_bundle(nside=4096, read_pattern=None, seed=1000, frame_time=3.04,
                nborder=4, skyorder=2, likelihood=False, device=None, config=None):
    """(arr, plan, cfg, geom) ready for ``l1_to_l2.make_core`` on ``device``.

    ``likelihood=True`` takes the likelihood fitter's plan (the
    reference's ``romancal_ramp_fit`` path); ``config``'s ``*_BACKEND``
    keys choose the kernels as in ``calibrateimage``.
    """
    device = resolve_device(device)
    config = config or {}
    read_pattern = read_pattern or READ_PATTERN_DEFAULT
    ngrp = len(read_pattern)
    cw = max(nside // 32, 4)  # synth_cal_arrays' default channelwidth
    nb = nborder
    meta = ramp.ma_table_meta(read_pattern, frame_time)
    if likelihood:
        plan = likely.build_likely_plan(meta, exclude_first=True)
    else:
        plan = ramp.build_plan(meta, 0.4 / 1.8 / 6.5**2, True, None)
    kernels = resolve_kernels(config, device)
    cfg = dict(
        exclude_first=True, backup=1, use_amp33=True, likelihood_fit=bool(likelihood),
        has_biascorr=False, has_dark_decay=False, wfi18=False,
        first_is_reset=(read_pattern[0] == [0]), has_ipc=True,
        ipc=kernels.ipc, lin=kernels.lin, med=kernels.med,
        has_dark_dq=False, skyorder=skyorder,
    )
    cal = synth_cal_arrays(nside, read_pattern, seed, frame_time, nborder)
    host = {
        "data": synth_l1_cube(cal, read_pattern, seed + 1),
        "amp33": np.full((ngrp, nside, cw), 29000.0, np.float32),
        "amp33_med": cal["amp33_med"],
        "dark_cube": cal["dark_cube"],
        "dark_slope": cal["dark_slope"],
        "dark_dq": np.zeros((nside, nside), np.uint32),
        "gain": cal["gain"],
        "read_sigma": cal["read_sigma"],
        "mask_dq": cal["mask_dq"],
        "saturation": cal["saturation"],
        "saturation_dq": cal["saturation_dq"],
        "biascorr": np.zeros((ngrp, nside - 2 * nb, nside - 2 * nb), np.float32),
        "lin_coefs": cal["lin_coefs"],
        "lin_smin": cal["lin_smin"],
        "lin_smax": cal["lin_smax"],
        "lin_sref": cal["lin_sref"],
        "lin_dq": cal["lin_dq"],
        "flat": cal["flat"],
        "area_factor": np.ones((nside, nside), np.float32),
        "dark_decay_signal": np.zeros(ngrp, np.float32),
    }
    if cfg["ipc"] in l1_to_l2.SLAB_ROUTES:
        host["ipc_kernel_padded"] = ipc_slab.kernel_planes_padded(
            cal["ipc_kernel"], th=l1_to_l2.SLAB_TH)
    else:
        host["ipc_kernel_frame"] = ipc_cuda.kernel_planes_frame(cal["ipc_kernel"], nside, nb)
    arr = {k: staging.stage(v, device, cache=False) for k, v in host.items()}
    arr["data"] = arr["data"].to(torch.float32)
    arr["opt_slope"] = torch.tensor(0.5, dtype=torch.float32, device=device)
    arr["dark_slope_ipc"], arr["flat_ipc"] = l1_to_l2.ipc_precal(
        cal["flat"], cal["dark_slope"], cal["gain"], cal["ipc_kernel"], nb, device)
    return arr, plan, cfg, (nside, nborder, cw)


def exposure_bundle(nside=4096, read_pattern=None, seed=1000, frame_time=3.04,
                    nborder=4, skyorder=2, device=None, config=None):
    """(arr, prep, pack) for the staged exposure runner
    (``noise_core.make_staged_exposure_runner``): ``prep`` the
    :func:`core_bundle` as ``prepare_inputs`` returns it, with ``config``'s
    kernels (:func:`..config.resolve_kernels`), ``pack`` the
    synthetic cal pack the sim reads, ``arr`` the runner's bundle
    (:func:`..pipeline.noise_core.exposure_arrays`) at a rate of 3 e/s."""
    device = resolve_device(device)
    read_pattern = read_pattern or READ_PATTERN_DEFAULT
    core_arr, plan, cfg, geom = core_bundle(nside, read_pattern, seed, frame_time,
                                            nborder, skyorder, device=device,
                                            config=config)
    cal = synth_cal_arrays(nside, read_pattern, seed, frame_time, nborder)
    cw = cal["channelwidth"]
    pack = CalPack(
        dark_cube=cal["dark_cube"], dark_slope=cal["dark_slope"],
        gain=cal["gain"], read_sigma=cal["read_sigma"],
        resetnoise=cal["resetnoise"], u_pink=0.4, c_pink=0.8,
        amp33_valid=True, amp33_med=cal["amp33_med"],
        amp33_std=np.full((nside, cw), 5.0, np.float32),
        amp33_m_pink=0.8, amp33_ru_pink=1.0,
        ipc_kernel=cal["ipc_kernel"], lin_coefs=cal["lin_coefs"],
        lin_smin=cal["lin_smin"], lin_smax=cal["lin_smax"],
        lin_sref=cal["lin_sref"], lin_dq=cal["lin_dq"],
        flat=cal["flat"], mask_dq=cal["mask_dq"],
        saturation=cal["saturation"], saturation_dq=cal["saturation_dq"],
    )
    na = nside - 2 * nborder
    prep = dict(
        arr=core_arr, plan=plan, cfg=cfg, geom=geom,
        read_pattern=[list(g) for g in read_pattern], frame_time=frame_time,
        meta=ramp.ma_table_meta(read_pattern, frame_time), weights_out=plan.W[-1],
        device=device, kernels=resolve_kernels(config or {}, device),
    )
    arr = noise_core.exposure_arrays(prep, np.full((na, na), 3.0, np.float32))
    return arr, prep, pack
