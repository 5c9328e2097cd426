"""Synthetic truth scenes, calibration reference files and L1 exposures.

Productionized equivalent of the reference test fixtures ``genfile`` /
``gencal`` (``tests/romanimpreprocess/test_workflow.py:32-332``) —
promoted to a first-class subsystem (per SURVEY.md §7 build order) so
that every pipeline test, benchmark, and demo can fabricate a fully
self-consistent detector model at any geometry:

- analytically controlled linearity (cubic Legendre with unit derivative
  and zero value at Sref),
- log-normal dark current, banded bias, gaussian gain,
- constant 3x3 IPC kernel with edge zeroing and center normalization,
- read/reset noise with 1/f amplitudes and amp33 reference-output stats,
- saturation = Smax - 50, threshold-derived mask, dark-decay table.

All files are written in the reference's CALDIR ASDF formats
(``docs/from_sim_README.rst:70-179``) via ``io.asdf_lite``.

:func:`synth_cal_arrays` / :func:`synth_l1_cube` build the same detector
model directly as arrays plus a plausible L1 ramp, and
:func:`write_l1_file` writes an L1 ASDF in the layout of the simulator
(``roman.data`` uint16 cube, ``roman.amp33``, the exposure read pattern
and frame time, the detector name), so a full-size CALDIR and L1 can be
made without a scene simulation.
"""

import numpy as np

from ..io import asdf_lite, fits_lite


def make_scene_file(path, nside_active=4088, nstars=25, exptime=139.8,
                    filt="F184", crval=(37.0, -20.0), seed=None,
                    image=None):
    """Write a synthetic truth FITS image (Gaussian stars + SIP TAN WCS).

    Mirrors reference ``genfile`` (``test_workflow.py:32-89``): star j
    has flux 10000*j e (over the exposure) at quasi-random grid points;
    the header carries EXPTIME/FILTER/SIP-TAN WCS/pointing keywords.
    ``image`` overrides the star field with a caller-supplied truth
    array (e.g. a polynomial sky for coefficient-recovery gates).
    Returns the path.
    """
    N = nside_active
    if image is not None:
        img = np.asarray(image, np.float64)
        if img.shape != (N, N):
            raise ValueError("image shape must be (nside_active,)*2")
    else:
        img = np.zeros((N, N))
        x_, y_ = np.meshgrid(np.arange(N), np.arange(N))
        for j in range(nstars):
            x = 10 + (N - 20) * j / float(nstars)
            y = 10 + (N - 20) * ((13 * j) % nstars) / float(nstars)
            img += 10000.0 * j * np.exp(
                -0.5 * ((x_ - x) ** 2 + (y_ - y) ** 2) / 2**2
            )

    h = fits_lite.Header()
    h["EXPTIME"] = float(exptime)
    h["FILTER"] = filt
    h["CRPIX1"] = (N + 1) / 2.0
    h["CRPIX2"] = (N + 1) / 2.0
    h["CD1_1"] = 3.0555555555555554e-05
    h["CD1_2"] = 0.0
    h["CD2_1"] = 0.0
    h["CD2_2"] = 3.0555555555555554e-05
    h["CTYPE1"] = "RA---TAN-SIP"
    h["CTYPE2"] = "DEC--TAN-SIP"
    h["CRVAL1"] = float(crval[0])
    h["CRVAL2"] = float(crval[1])
    h["LONPOLE"] = 215.0
    h["A_ORDER"] = 2
    h["A_0_2"] = 2.0e-6
    h["A_1_1"] = -1.0e-6
    h["A_2_0"] = 3.0e-6
    h["B_ORDER"] = 2
    h["B_0_2"] = 1.4e-5
    h["B_1_1"] = -1.0e-5
    h["B_2_0"] = 3.0e-7
    h["RA_TARG"] = float(crval[0])
    h["DEC_TARG"] = float(crval[1])
    h["PA_OBSY"] = 185.0
    h["DATE-OBS"] = "2026-01-01 00:00:00"
    fits_lite.PrimaryHDU(img.astype(np.float32), header=h).writeto(path)
    return path


def make_cal_files(cstem, read_pattern, nside=4096, nborder=4,
                   frame_time=3.04, seed=1000, tag="SYNTH", sca=4,
                   channelwidth=None):
    """Write the full CALDIR set of synthetic calibration ASDF files.

    Returns the CALDIR dict mapping reference-file type -> path.
    Geometry is parameterizable so tests can run small (nside=128)
    while production uses 4096.
    """
    rng = np.random.RandomState(seed)
    N = nside
    N_ = nside - 2 * nborder
    dtrim = nborder
    cw = channelwidth if channelwidth is not None else max(N // 32, 4)
    ngrp = len(read_pattern)
    t = np.array([frame_time * np.mean(np.asarray(g)) for g in read_pattern])
    x, y = np.meshgrid(np.arange(N), np.arange(N))

    def fname(ctype):
        return f"{cstem}_{ctype}_{tag}_SCA{sca:02d}.asdf"

    caldir = {}

    # --- biascorr (trivial; schema check) --------------------------------
    asdf_lite.AsdfFile(
        {
            "roman": {
                "data": np.zeros((ngrp, N_, N_), dtype=np.float32),
                "t0": float(t[1]),
            }
        }
    ).write_to(fname("biascorr"))
    caldir["biascorr"] = fname("biascorr")

    # --- dark ------------------------------------------------------------
    dark_slope = 0.005 * 10.0 ** rng.normal(0.0, 1.0, (N, N))
    dark_slope[:dtrim, :] = 0.0
    dark_slope[-dtrim:, :] = 0.0
    dark_slope[:, :dtrim] = 0.0
    dark_slope[:, -dtrim:] = 0.0
    bias = (
        13000.0
        + 200 * np.cos(2 * np.pi * x / 256.0)
        + 100 * np.sin(2 * np.pi * y / 256.0) ** 3
    )
    asdf_lite.AsdfFile(
        {
            "roman": {
                "data": np.clip(
                    bias[None] + dark_slope[None] * t[:, None, None], 0.0, 65535.0
                ).astype(np.float32),
                "dq": np.zeros((N, N), dtype=np.uint32),
                "dark_slope": dark_slope.astype(np.float32),
                "dark_slope_err": np.zeros((N, N), dtype=np.float32),
            }
        }
    ).write_to(fname("dark"))
    caldir["dark"] = fname("dark")

    # --- gain ------------------------------------------------------------
    gain = np.clip(1.5 + 0.03 * rng.normal(0.0, 1.0, (N, N)), 1.4, 1.6)
    asdf_lite.AsdfFile(
        {"roman": {"data": gain.astype(np.float32),
                   "dq": np.zeros((N, N), dtype=np.uint32)}}
    ).write_to(fname("gain"))
    caldir["gain"] = fname("gain")

    # --- ipc4d -----------------------------------------------------------
    K = np.zeros((3, 3, N_, N_), dtype=np.float32)
    K[0, 1] = K[2, 1] = 0.015
    K[1, 0] = K[1, 2] = 0.013
    K[0, 0] = K[2, 2] = K[0, 2] = K[2, 0] = 0.002
    # zero contributions that would leave the science array
    K[0, :, 0, :] = 0.0
    K[:, 0, :, 0] = 0.0
    K[-1, :, -1, :] = 0.0
    K[:, -1, :, -1] = 0.0
    K[1, 1] = 1.0 - K.sum(axis=(0, 1)) + K[1, 1]
    asdf_lite.AsdfFile(
        {"roman": {"data": K, "dq": np.zeros((N, N), dtype=np.uint32)}}
    ).write_to(fname("ipc4d"))
    caldir["ipc4d"] = fname("ipc4d")

    # --- linearitylegendre -----------------------------------------------
    Smin = np.clip(5000 + 500 * np.cos((x + 3 * y) / 100.0), 0.5, 65534.5)
    Smax = np.clip(56000 + 10000 * rng.uniform(size=(N, N)), 0.5, 65534.5)
    Smin = Smin.astype(np.float32)
    Smax = Smax.astype(np.float32)
    Sref = (Smin + 300 + 100 * (x % 2)).astype(np.float32)
    data = np.zeros((4, N, N), dtype=np.float32)
    data[2] = 20 + 180 * rng.uniform(size=(N, N))
    # cubic built so d(Slin)/dS = 1 and Slin = 0 at S = Sref
    z = 2 * (Sref - Smin) / (Smax - Smin) - 1
    data[1] = (Smax - Smin) / 2.0 - 3 * data[2] * z
    data[0] = -data[1] * z - data[2] * (1.5 * z**2 - 0.5)
    pflat = (
        0.95 + 0.1 * (x / N - 1) - 0.2 * (y / N * (1 - y / N))
    ).astype(np.float32)
    pflat[:dtrim, :] = 0.0
    pflat[-dtrim:, :] = 0.0
    pflat[:, :dtrim] = 0.0
    pflat[:, -dtrim:] = 0.0
    asdf_lite.AsdfFile(
        {
            "roman": {
                "data": data,
                "dq": np.zeros((N, N), dtype=np.uint32),
                "Smin": Smin,
                "Smax": Smax,
                "Sref": Sref,
                "dark": dark_slope.astype(np.float32),
                "pflat": pflat,
                "ramperr": np.ones((2, N, N), dtype=np.uint16),
            }
        }
    ).write_to(fname("linearitylegendre"))
    caldir["linearitylegendre"] = fname("linearitylegendre")

    # --- mask ------------------------------------------------------------
    mask = np.zeros((N, N), dtype=np.uint32)
    mask[:dtrim, :] |= 2**31
    mask[-dtrim:, :] |= 2**31
    mask[:, :dtrim] |= 2**31
    mask[:, -dtrim:] |= 2**31
    mask |= np.where(
        dark_slope > 0.25, np.where(dark_slope > 12.5, 2**11, 2**12), 0
    ).astype(np.uint32)
    asdf_lite.AsdfFile({"roman": {"dq": mask}}).write_to(fname("mask"))
    caldir["mask"] = fname("mask")

    # --- pflat (flat) ----------------------------------------------------
    asdf_lite.AsdfFile(
        {"roman": {"data": pflat, "dq": np.zeros((N, N), np.uint32)}}
    ).write_to(fname("pflat"))
    caldir["flat"] = fname("pflat")

    # --- read ------------------------------------------------------------
    medband = np.full((N, cw), 29000.0, dtype=np.float32)
    stdband = np.full((N, cw), 4.0, dtype=np.float32)
    step = max(N // 16, 2)
    for i in range(0, N, step):
        stdband[i, :] = 5.0
        medband[i, :] += 30.0
        if i + 1 < N:
            medband[i + 1, :] += 15.0
    asdf_lite.AsdfFile(
        {
            "roman": {
                "anc": {"U_PINK": 0.4, "C_PINK": 0.8},
                "data": (6.0 + 5.0 * rng.uniform(size=(N, N))).astype(np.float32),
                "resetnoise": (25.0 + 5.0 * rng.uniform(size=(N, N))).astype(
                    np.float32
                ),
                "amp33": {
                    "valid": True,
                    "med": medband,
                    "std": stdband,
                    "M_PINK": 0.8,
                    "RU_PINK": 1.0,
                },
            }
        }
    ).write_to(fname("read"))
    caldir["read"] = fname("read")

    # --- saturation ------------------------------------------------------
    asdf_lite.AsdfFile(
        {
            "roman": {
                "data": np.clip(Smax - 50, 1.5, None).astype(np.float32),
                "dq": np.zeros((N, N), np.uint32),
            }
        }
    ).write_to(fname("saturation"))
    caldir["saturation"] = fname("saturation")

    # --- dark decay ------------------------------------------------------
    dectab = {
        f"WFI{k:02d}": {
            "amplitude": 0.3 + 0.1 * np.cos(k),
            "time_constant": 20.0 + k,
        }
        for k in range(1, 19)
    }
    asdf_lite.AsdfFile({"roman": {"decay_table": dectab}}).write_to(
        fname("darkdecay")
    )
    caldir["_darkdecay_path"] = fname("darkdecay")

    return caldir


READ_PATTERN_DEFAULT = [[0], [1, 2], [3, 4, 5], [6, 7, 8, 9, 10], [11, 12], [13]]


def synth_cal_arrays(nside, read_pattern, seed=1000, frame_time=3.04,
                     nborder=4, channelwidth=None):
    """Synthetic calibration arrays (host numpy), synth-generator model."""
    rng = np.random.RandomState(seed)
    N = nside
    nb = nborder
    N_ = N - 2 * nb
    cw = channelwidth or max(N // 32, 4)
    ngrp = len(read_pattern)
    t = np.array([frame_time * np.mean(np.asarray(g)) for g in read_pattern])
    x, y = np.meshgrid(np.arange(N), np.arange(N))

    dark_slope = 0.005 * 10.0 ** rng.normal(0.0, 1.0, (N, N)).astype(np.float32)
    for sl in (np.s_[:nb, :], np.s_[-nb:, :], np.s_[:, :nb], np.s_[:, -nb:]):
        dark_slope[sl] = 0.0
    bias = (
        13000.0
        + 200 * np.cos(2 * np.pi * x / 256.0)
        + 100 * np.sin(2 * np.pi * y / 256.0) ** 3
    )
    dark_cube = np.clip(
        bias[None] + dark_slope[None] * t[:, None, None], 0, 65535
    ).astype(np.float32)
    gain = np.clip(1.5 + 0.03 * rng.normal(size=(N, N)), 1.4, 1.6).astype(
        np.float32
    )

    K = np.zeros((3, 3, N_, N_), dtype=np.float32)
    K[0, 1] = K[2, 1] = 0.015
    K[1, 0] = K[1, 2] = 0.013
    K[0, 0] = K[2, 2] = K[0, 2] = K[2, 0] = 0.002
    K[0, :, 0, :] = 0.0
    K[:, 0, :, 0] = 0.0
    K[-1, :, -1, :] = 0.0
    K[:, -1, :, -1] = 0.0
    K[1, 1] = 1.0 - K.sum(axis=(0, 1)) + K[1, 1]

    Smin = np.clip(5000 + 500 * np.cos((x + 3 * y) / 100.0), 0.5, 65534.5).astype(np.float32)
    Smax = np.clip(56000 + 10000 * rng.uniform(size=(N, N)), 0.5, 65534.5).astype(np.float32)
    Sref = (Smin + 300 + 100 * (x % 2)).astype(np.float32)
    coefs = np.zeros((4, N, N), dtype=np.float32)
    coefs[2] = 20 + 180 * rng.uniform(size=(N, N))
    z = 2 * (Sref - Smin) / (Smax - Smin) - 1
    coefs[1] = (Smax - Smin) / 2.0 - 3 * coefs[2] * z
    coefs[0] = -coefs[1] * z - coefs[2] * (1.5 * z**2 - 0.5)

    flat = (0.95 + 0.1 * (x / N - 1) - 0.2 * (y / N * (1 - y / N))).astype(np.float32)

    mask = np.zeros((N, N), dtype=np.uint32)
    for sl in (np.s_[:nb, :], np.s_[-nb:, :], np.s_[:, :nb], np.s_[:, -nb:]):
        mask[sl] |= 2**31

    return dict(
        ngrp=ngrp,
        dark_cube=dark_cube,
        dark_slope=dark_slope,
        gain=gain,
        read_sigma=(6.0 + 5.0 * rng.uniform(size=(N, N))).astype(np.float32),
        resetnoise=(25.0 + 5.0 * rng.uniform(size=(N, N))).astype(np.float32),
        ipc_kernel=K,
        lin_coefs=coefs,
        lin_smin=Smin,
        lin_smax=Smax,
        lin_sref=Sref,
        lin_dq=np.zeros((N, N), np.uint32),
        flat=flat,
        mask_dq=mask,
        saturation=np.clip(Smax - 50, 1.5, None).astype(np.float32),
        saturation_dq=np.zeros((N, N), np.uint32),
        amp33_med=np.full((N, cw), 29000.0, np.float32),
        channelwidth=cw,
        bias=bias.astype(np.float32),
        t=t,
    )


def synth_l1_cube(cal, read_pattern, seed=7, rate_dn_s=1.0, nborder=0):
    """Plausible L1 ramp: bias + rate*t + read noise, uint16.

    ``nborder > 0`` keeps the sky rate off the reference-pixel border,
    as on the detector (the reference-pixel correction then leaves the
    active rate in place); :func:`injected_rate` gives the rate map."""
    rng = np.random.RandomState(seed)
    N = cal["gain"].shape[0]
    ngrp = len(read_pattern)
    rate = injected_rate(N, rate_dn_s, rng, nborder)
    data = (
        cal["bias"][None]
        + (cal["dark_slope"] + rate)[None] * cal["t"][:, None, None]
        + rng.normal(0, 6, (ngrp, N, N))
    )
    return np.clip(np.round(data), 0, 65535).astype(np.uint16)


def injected_rate(nside, rate_dn_s=1.0, rng=None, nborder=0, seed=7):
    """The sky rate map (DN/s) that :func:`synth_l1_cube` injects (pass
    the same ``seed``, or its ``rng`` state)."""
    rng = np.random.RandomState(seed) if rng is None else rng
    rate = rate_dn_s * (0.5 + rng.uniform(size=(nside, nside)).astype(np.float32))
    if nborder > 0:
        border = np.ones((nside, nside), bool)
        border[nborder:-nborder, nborder:-nborder] = False
        rate[border] = 0.0
    return rate


def synth_amp33(nside, ngrp, channelwidth, seed=11, level=29000.0,
                sigma=4.0):
    """Plausible amp33 reference-output cube (ngrp, nside, cw), uint16:
    the synthetic read file's median level plus white noise."""
    rng = np.random.RandomState(seed)
    a = level + rng.normal(0.0, sigma, (ngrp, nside, channelwidth))
    return np.clip(np.round(a), 0, 65535).astype(np.uint16)


def write_l1_file(path, data, read_pattern, frame_time=3.04,
                  detector="WFI04", amp33=None):
    """Write an L1 ASDF: ``roman.data`` (ngrp, nside, nside) uint16,
    optional ``roman.amp33``, and the meta the L1 -> L2 driver reads.
    Returns the path."""
    ngrp = len(read_pattern)
    if data.shape[0] != ngrp or data.dtype != np.uint16:
        raise ValueError("data must be a (ngrp, nside, nside) uint16 cube")
    l1 = {
        "meta": {
            "exposure": {
                "read_pattern": [list(map(int, g)) for g in read_pattern],
                "frame_time": float(frame_time),
                "nresultants": ngrp,
                "exposure_time": float(frame_time) * (
                    read_pattern[-1][-1] - read_pattern[0][0]),
            },
            "instrument": {"detector": detector},
        },
        "data": data,
    }
    if amp33 is not None:
        l1["amp33"] = amp33
    asdf_lite.AsdfFile({"roman": l1}).write_to(path)
    return path
