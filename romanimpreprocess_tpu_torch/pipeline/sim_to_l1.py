"""Sim -> L1: OpenUniverse truth image to Level-1 MultiAccum ramp cube.

Re-implements the reference's ``from_sim/sim_to_isim.py`` (Image2D,
make_l1_fullcal, fill_in_refdata_and_1f, run_config) with full detector
physics, in PyTorch:

- scene/sky/dark charge is drawn as **independent per-read Poisson
  increments** (the Poisson-process decomposition of the reference's
  total-Poisson + sequential binomial apportionment,
  ``romanisim.l1.apportion_counts_to_resultants`` via
  ``sim_to_isim.py:233`` — identical joint distribution, but parallel
  across reads), contracted into resultants,
- cosmic-ray hits per read interval (Poisson count x log-normal charge),
- reset noise, the IL forward model (IPC convolution + gain +
  24-iteration bisection linearity inverse) applied to all resultants,
- read noise /sqrt(N) per group, bias correction, integer rounding,
- reference pixels/1-f banding/amp33 synthesis
  (``fill_in_refdata_and_1f``, ``sim_to_isim.py:306-402``): per-channel
  pink noise with odd-channel mirroring, shared reset noise, dark-cube
  border fill, uint16 clip,
- EXTRACT_REF reference-read subtraction with data_encoding_offset
  (``sim_to_isim.py:711-730``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
``IPC_BACKEND``, ``LIN_BACKEND`` and ``PINK_BACKEND`` choose between
the hand-written CUDA kernels (forward IPC, the bisection inverse of the
linearity, pink-noise transform) and their plain PyTorch versions,
``CONTRACT_BACKEND`` between ``torch.einsum`` and the contraction kernel
(:func:`..config.resolve_kernels`, once in :meth:`Image2D.simulate`).
Arrays cross between host and device through :mod:`..io.staging`.

While a ``torch.profiler`` records, the steps are ranges of
:mod:`..utils.profiling`, none inside another: the sim's
``sim_to_l1.<stage>`` (``reset``, ``poisson``, ``contract``,
``cosmic_rays``, ``ipc_fwd``, ``inv_linearity``, ``read_noise``) and the
fill's ``sim_to_l1.fill.<stage>`` (``border``, ``pink``, ``banding``,
``amp33``, ``round_clip``); every draw counts its variates on
``rng_draws`` (:mod:`..ops.rand`).

Randomness.  One ``torch.Generator`` on the device, seeded from
``SEED``, is consumed in this fixed order:

1. reset noise, (na, na) normals;
2. the per-read Poisson increments, (nreads, na, na);
3. cosmic rays: the event count (one Poisson), then read index, row
   and column (three ``randint`` of the candidate-list length), the
   charge normals, the track direction uniforms, the two neighbour
   fractions;
4. read noise, (ngrp, na, na) normals;
5. the border strips bottom, top, left, right: for each, its white
   normals (ngrp, ...) and then its shared reset normals;
6. the white spectrum of the pink frames;
7. the amp33 white normals, (ngrp, nside, channelwidth).

Two runs with one seed on one device give the same file; parity with
the reference's JAX random streams is statistical.  The cosmic-ray
deposit is ``index_put_(accumulate=True)``: where two events hit one
pixel (probability about N^2 / M for N events on M sites) the order of
the two float adds is the backend's.
"""

import argparse
import re

import numpy as np
import torch

from .. import __version__, pars
from ..config import load_config, reads_to_pattern, resolve_device, resolve_kernels
from ..dqflags import group as gdq
from ..dqflags import i32
from ..io import asdf_lite, calfiles, fits_lite
from ..ops import (contract_cuda, invlin_cuda, ipc, ipc_cuda, linearity, pink, ramp,
                   rand, wcsutils)
from ..io.staging import place, stage, to_numpy, u16_to_host
from ..utils import profiling, skymodel, typefix
from ..utils.profiling import StageRanges

# Cosmic-ray model: flux [hits/cm^2/s] x pixel area [cm^2], log-normal
# charge.  Tuned to the reference's test envelope of 10k-30k JUMP_DET
# pixels per 4088^2, 139.8 s exposure (test_workflow.py:624-627;
# romanisim's default CR flux is ~8 /cm^2/s with 10 um pixels).
CR_RATE_PER_PIX_S = 8.0 * 1.0e-6  # hits / pixel / s
CR_CHARGE_MU = np.log(1000.0)  # log-normal median 1000 e
CR_CHARGE_SIGMA = 1.0

_PREFIX = "sim_to_l1"


def read_pattern_to_tij(read_pattern, frame_time=None):
    """Read pattern -> per-read timestamps (romanisim.l1.read_pattern_to_tij)."""
    ft = pars.read_time if frame_time is None else frame_time
    return [[ft * idx for idx in grp] for grp in read_pattern]


def contraction_matrix(read_pattern):
    """The (ngrp, nreads) float32 matrix T with

        resultant_j = mean_{r in group j} cumsum(inc)_r = sum_r T[j, r] inc_r,

    T[j, r] = (# reads in group j at index >= r) / N_j, the
    cumulative-membership contraction.  Column 0 is zero: read 0 is at
    t = 0, no charge is collected before it."""
    nreads = read_pattern[-1][-1] + 1
    T = np.zeros((len(read_pattern), nreads), np.float64)
    for j, grp in enumerate(read_pattern):
        for r in grp:
            T[j, : r + 1] += 1.0 / len(grp)
    T[:, 0] = 0.0
    return T.astype(np.float32)


class IL:
    """IPC + inverse-linearity forward model (reference
    ``ipc_linearity.IL:398-513``): linearized electrons -> raw DN.

    Holds tensors of one device.  ``ipc_backend='cuda'`` sends a 3-D
    batch through the forward-IPC kernel (:func:`..ops.ipc_cuda.ipc_fwd_cube`),
    ``lin_backend='cuda'`` the division by the gain and the bisection
    inverse through kernel D (:func:`..ops.invlin_cuda.invert_linearity_fused`).
    """

    def __init__(self, lin, gain, ipc_kernel=None, start_e=0.0,
                 ipc_backend="xla", lin_backend="xla"):
        self.lin = lin  # LinearityData (full frame)
        self.gain = gain  # (ny, nx) full frame
        self.ipc_kernel = ipc_kernel  # (3, 3, na, na) or None
        self.start_e = start_e  # scalar or (na, na) electrons
        self.ipc_backend = ipc_backend
        self.lin_backend = lin_backend

    def apply(self, counts_e):
        """Electrons (active region) -> raw DN (active region).

        Accepts a 2-D frame or a (ngrp, na, na) batch."""
        with profiling.span(f"{_PREFIX}.ipc_fwd"):
            x = counts_e + self.start_e
            if self.ipc_kernel is not None:
                if self.ipc_backend == "cuda" and x.ndim == 3:
                    x = ipc_cuda.ipc_fwd_cube(x.contiguous(), self.ipc_kernel)
                else:
                    x = ipc.ipc_fwd(x, self.ipc_kernel)
        with profiling.span(f"{_PREFIX}.inv_linearity"):
            inverse = (invlin_cuda.invert_linearity_fused if self.lin_backend == "cuda"
                       else invlin_cuda.invert_linearity_plain)
            S, _ = inverse(x, self.gain, self.lin)
        return S


def _accumulate_resultants(gen, lam_per_read, read_pattern, crparam,
                           stages, contract="dot"):
    """Draw per-read Poisson increments and average cumulative charge
    into resultants.

    lam_per_read : (na, na) rate in e/frame (uniform frame time assumed
        within the MA table).
    contract : 'dot' (one ``torch.einsum``) or 'cuda' (the streaming
        contraction kernel, :mod:`..ops.contract_cuda`).
    stages : the caller's :class:`StageRanges`, for the profiler labels.
    Returns (resultants_e (ngrp, na, na), crhits (ngrp, na, na) int32 —
    hits AFFECTING each resultant, i.e. the hit's group and later ones,
    romanisim's "flag from the jump resultant onward" semantics).
    """
    dev = lam_per_read.device
    nreads = read_pattern[-1][-1] + 1
    ngrp = len(read_pattern)
    na = lam_per_read.shape[0]
    T_d = torch.from_numpy(contraction_matrix(read_pattern)).to(dev)

    # one (nreads, na, na) draw and one contraction replace the
    # reference's sequential per-read accumulation; the cube (about
    # 1 GB at 4096^2) is dropped as soon as it is contracted
    stages("poisson")
    incs = rand.poisson(gen, lam_per_read, shape=(nreads, na, na))
    stages("contract")
    if contract == "cuda":
        res = contract_cuda.contract_reads(T_d, incs)
    else:
        res = torch.einsum("jr,ryx->jyx", T_d, incs)
    del incs

    crh = torch.zeros((ngrp, na, na), dtype=torch.int32, device=dev)
    if crparam is None:
        return res, crh

    # CRs as a thinned Poisson point process: hits are ~3e-7 of the
    # pixel-read sites, so instead of dense per-read hit/charge maps,
    # draw a fixed-size list of K candidate events, keep the first
    # N ~ Poisson(p*M) of them, and scatter-add the deposits.  The
    # per-site-Bernoulli and uniform-position-list formulations are the
    # same point process (double-hit collisions have probability ~N^2/M
    # and are physically legal anyway).  Track extent: a CR crosses
    # ~3 pixels (romanisim models secant tracks; the reference envelope
    # of 10k-30k flagged pixels per exposure implies multiplicity ~3) —
    # scaled deposits in the two neighbors along a random axis;
    # neighbors falling outside the array are dropped.
    stages("cosmic_rays")
    p_hit = CR_RATE_PER_PIX_S * crparam.get("frame_time", pars.read_time)
    lam_cr = p_hit * (nreads - 1) * na * na  # read 0 is at t=0
    # candidate cap at +8 sigma: truncation probability is negligible
    kcap = max(256, int(-(-(lam_cr + 8.0 * lam_cr**0.5 + 8.0) // 256)) * 256)
    n_cr = rand.poisson(gen, lam_cr, shape=(1,))[0]
    active = torch.arange(kcap, dtype=torch.float32, device=dev) < n_cr

    def randint(lo, hi):
        return rand.integers(gen, lo, hi, (kcap,))

    rr = randint(1, nreads)
    yy = randint(0, na)
    xx = randint(0, na)
    q = torch.exp(CR_CHARGE_MU + CR_CHARGE_SIGMA * rand.normal(gen, (kcap,)))
    horiz = rand.uniform(gen, (kcap,)) < 0.5
    fr = 0.3 + 0.7 * rand.uniform(gen, (2, kcap))

    dy = (~horiz).to(torch.int64)
    dx = horiz.to(torch.int64)
    # event list: center + two track neighbors
    ev_r = torch.cat([rr, rr, rr])
    ev_y = torch.cat([yy, yy - dy, yy + dy])
    ev_x = torch.cat([xx, xx - dx, xx + dx])
    ev_q = torch.cat([q, q * fr[0], q * fr[1]])
    keep = (torch.cat([active] * 3) & (ev_y >= 0) & (ev_y < na)
            & (ev_x >= 0) & (ev_x < na))
    ev_y = ev_y.clamp(0, na - 1)
    ev_x = ev_x.clamp(0, na - 1)

    # deposit CRs in the RESULTANT domain: a hit at read r adds q to
    # every cumsum at reads >= r, so its per-resultant weight is exactly
    # T[j, r] (the cumulative-membership column).  This keeps the
    # Poisson cube out of the scatter entirely.
    w = T_d[:, ev_r]  # (ngrp, nev)
    wq = w * (ev_q * keep)[None]
    jj = torch.arange(ngrp, device=dev)[:, None]
    res.index_put_((jj, ev_y[None], ev_x[None]), wq, accumulate=True)
    # T[j, r_e] > 0 exactly when the hit at read r_e changes resultant j
    # (its group or a later one): per-group hit maps give romanisim's
    # from-the-jump-onward flagging, not a whole-ramp flag
    hitw = ((w > 0) & keep[None]).to(torch.int32)
    crh.index_put_((jj, ev_y[None], ev_x[None]), hitw, accumulate=True)
    return res, crh


def _staged_lin(pack, device, rows):
    """The pack's linearity arrays, staged once per device, at ``rows``
    and the same columns."""
    names = ("lin_coefs", "lin_smin", "lin_smax", "lin_sref", "lin_dq")
    return linearity.LinearityData(*(stage(getattr(pack, n), device)[..., rows, rows]
                                     for n in names))


def make_l1_fullcal(gen, counts_rate_e, read_pattern, pack, frame_time=None,
                    crparam=None, persistence=None, ipc_backend="xla",
                    contract="dot", lin_backend="xla"):
    """Counts rate (e/s, active region) -> L1 resultants in raw DN.

    Mirrors reference ``make_l1_fullcal`` (``sim_to_isim.py:163-262``):
    reset noise, the IL forward model on all resultants, read noise,
    biascorr, rounding.  Runs on ``gen``'s device.  Returns
    (resultants_DN (ngrp, na, na) float32, resultantdq (ngrp, na, na)
    int32 bit patterns of the uint32 dq).

    ``persistence`` is an optional (na, na) charge rate in e/s from
    prior exposures, added to the per-pixel rate before the Poisson
    draw.  The reference threads a ``romanisim.persistence.Persistence``
    object through the same call (``sim_to_isim.py:676-691``, always a
    fresh/empty one so zero physics there too); here the hook takes the
    evaluated rate image directly.  ``ipc_backend`` and ``lin_backend``
    choose the IL forward model's kernels (:class:`IL`).
    """
    dev = gen.device
    stages = StageRanges(_PREFIX)
    stages("reset")
    rate_e = place(counts_rate_e, dev).to(torch.float32)
    if persistence is not None:
        rate_e = rate_e + place(persistence, dev)
    ft = float(pars.read_time if frame_time is None else frame_time)
    nside = pack.gain.shape[0]
    na = rate_e.shape[0]
    nb = (nside - na) // 2
    act = slice(nb, nside - nb)
    ngrp = len(read_pattern)

    gain = stage(pack.gain, dev)
    gain_act = gain[act, act]
    # reset noise in electrons (sim_to_isim.py:194-215)
    reset_e = (rand.normal(gen, (na, na))
               * stage(pack.resetnoise, dev)[act, act] * gain_act)
    if pack.biascorr is not None:
        reset_e = reset_e - (np.float32(pack.biascorr_t0)
                             * stage(pack.dark_slope, dev)[act, act] / gain_act)

    lin = _staged_lin(pack, dev, slice(None))
    il = IL(lin, gain,
            stage(pack.ipc_kernel, dev) if pack.ipc_kernel is not None else None,
            start_e=reset_e, ipc_backend=ipc_backend, lin_backend=lin_backend)

    lam_per_frame = torch.clamp(rate_e * ft, min=0.0)
    res_e, crhits = _accumulate_resultants(
        gen, lam_per_frame, read_pattern,
        {"frame_time": ft} if crparam is not None else None, stages,
        contract=contract,
    )

    # IL forward model, batched over resultants (electrons -> raw DN):
    # its own two ranges, sim_to_l1.ipc_fwd and .inv_linearity
    stages.close()
    resultants = il.apply(res_e)
    del res_e

    # read noise / sqrt(N_j) (add_read_noise_to_resultants)
    stages("read_noise")
    nvec = torch.tensor([len(g) for g in read_pattern], dtype=torch.float32,
                        device=dev)
    resultants = resultants + (
        rand.normal(gen, (ngrp, na, na))
        * stage(pack.read_sigma, dev)[act, act]
        / torch.sqrt(nvec)[:, None, None]
    )
    if pack.biascorr is not None:
        bc = stage(pack.biascorr, dev)
        resultants = resultants + bc[bc.shape[0] - ngrp:]
    resultants = torch.round(resultants)  # half to even

    # dq: JUMP_DET on the resultants a CR affects (its group and later),
    # plus the linearity cal file's per-pixel dq copied into every group
    # (reference IL.set_dq, ``ipc_linearity.py:438-459``)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    dq = torch.where(crhits > 0, i32(gdq.JUMP_DET), zero) | lin.dq[act, act]
    stages.close()
    return resultants, dq


def _to_u16_range(x):
    """Round (half to even) and clip to [0, 65535]; int32, because torch
    has thin uint16 support (:func:`..io.staging.u16_to_host` narrows it)."""
    return torch.clamp(torch.round(x), 0, 65535).to(torch.int32)


def fill_in_refdata_and_1f(gen, im, pack, read_pattern, nside, channelwidth,
                           fill_in_banding=True, amp33=None, nborder=4,
                           pink_backend="xla"):
    """Fill reference pixels and add 1/f banding + amp33 (device).

    Mirrors reference ``fill_in_refdata_and_1f`` (``sim_to_isim.py:306-402``):
    the full frame starts as a synthetic dark (white read noise /sqrt(N)
    + shared reset noise + dark cube), the active region is overwritten
    with ``im``, then per-group banding is added: a common 1/f frame
    (C_PINK) plus per-channel unique frames (U_PINK), odd channels
    mirrored; the amp33 block gets median + white*std + RU_PINK*own-pink
    + M_PINK*common.  Output rounded and clipped to the uint16 range.

    ``im`` is the (ngrp, na, na) active cube or a (ngrp, nside, nside)
    frame whose active region is taken.  Returns (im (ngrp, nside,
    nside), amp33 (ngrp, nside, channelwidth) or None), int32 tensors of
    values in [0, 65535] on ``gen``'s device.
    """
    dev = gen.device
    stages = StageRanges(f"{_PREFIX}.fill")
    stages("border")
    ngrp = im.shape[0]
    nb = nborder
    nch = nside // channelwidth
    do_amp33 = amp33 is not None and pack.amp33_valid
    read_sigma = stage(pack.read_sigma, dev)
    resetnoise = stage(pack.resetnoise, dev)
    dark_cube = stage(pack.dark_cube, dev)
    dark_cube = dark_cube[dark_cube.shape[0] - ngrp:]
    sq = torch.sqrt(torch.tensor([len(g) for g in read_pattern],
                                 dtype=torch.float32, device=dev))

    # The synthetic-dark noise (white/sqrt(N) + shared reset + dark
    # ramp) only survives on the reference border — the active region
    # is overwritten by the science data — so it is drawn per border
    # STRIP, not per full frame.
    def strip(sl_y, sl_x, shape):
        w = rand.normal(gen, shape)
        r = rand.normal(gen, shape[1:])
        return (w * read_sigma[sl_y, sl_x] / sq[:, None, None]
                + r * resetnoise[sl_y, sl_x]
                + dark_cube[:, sl_y, sl_x])

    mid_y = slice(nb, nside - nb)
    bot = strip(slice(0, nb), slice(None), (ngrp, nb, nside))
    top = strip(slice(nside - nb, nside), slice(None), (ngrp, nb, nside))
    left = strip(mid_y, slice(0, nb), (ngrp, nside - 2 * nb, nb))
    right = strip(mid_y, slice(nside - nb, nside), (ngrp, nside - 2 * nb, nb))

    src = (im if im.shape[-1] != nside
           else im[:, nb:-nb, nb:-nb]).to(torch.float32)
    noise = torch.cat([bot, torch.cat([left, src, right], dim=2), top], dim=1)

    amp33_out = None
    if fill_in_banding:
        # frames: per group, 1 common + nch unique (+1 amp33)
        stages("pink")
        per_grp = 1 + nch + (1 if do_amp33 else 0)
        frames = pink.pink_frames(gen, ngrp * per_grp, nside, channelwidth,
                                  backend=pink_backend)
        stages("banding")
        frames = frames.reshape(ngrp, per_grp, nside, channelwidth)
        common = frames[:, 0] * np.float32(pack.c_pink)
        uniq = frames[:, 1 : 1 + nch] * np.float32(pack.u_pink)
        # odd channels are read in the reverse x direction: the WHOLE
        # per-channel band (unique + common) is mirrored, as in the
        # reference (``sim_to_isim.py:384-386``).  A pink frame is a
        # row-major reshape of one contiguous 1/f stream, so its
        # covariance is R(|cw*dr + dc|) — flipping changes the cross-row
        # orientation to R(|cw*dr - dc|), which for 1/f noise is NOT a
        # distributional no-op.
        band = uniq + common[:, None]  # (ngrp, nch, nside, cw)
        odd = (torch.arange(nch, device=dev) % 2 == 1)[None, :, None, None]
        band = torch.where(odd, band.flip(-1), band)
        band = band / sq[:, None, None, None]
        noise = noise + band.permute(0, 2, 1, 3).reshape(ngrp, nside, nside)
        del band, uniq

        if do_amp33:
            stages("amp33")
            white = (rand.normal(gen, (ngrp, nside, channelwidth))
                     * stage(pack.amp33_std, dev))
            pinkref = (np.float32(pack.amp33_ru_pink) * frames[:, -1]
                       + np.float32(pack.amp33_m_pink) * common)
            a33 = stage(pack.amp33_med, dev) + (white + pinkref) / sq[:, None, None]
            amp33_out = _to_u16_range(a33)

    stages("round_clip")
    im_out = _to_u16_range(noise)
    stages.close()
    return im_out, (amp33_out if do_amp33 else None)


def _caldir_files(caldir):
    return {k: v for k, v in caldir.items() if k != "NO_AMP33"}


class Image2D:
    """2-D truth image with WCS and metadata (reference ``Image2D:405``)."""

    def __init__(self, intype, **kwargs):
        if intype == "anlsim":
            self.init_anlsim(kwargs["fname"])
        else:
            raise ValueError(f"unknown input type {intype!r}")

    def init_anlsim(self, fname, flip=True):
        m = re.search(r"_(\d+)_(\d+)\.fits", fname)
        if m is None:
            raise ValueError(
                "anlsim input filename must end in _<obsid>_<sca>.fits "
                f"(e.g. truth_F184_163_4.fits); got {fname!r}"
            )
        self.idsca = (int(m.group(1)), int(m.group(2)))
        hdus = fits_lite.open_fits(fname)
        data = np.array(hdus[0].data, dtype=np.float64)
        self.header = hdus[0].header
        if flip:
            if self.idsca[1] % 3 == 0:
                wcsutils.sip_hflip(data, self.header)
            else:
                wcsutils.sip_vflip(data, self.header)
        self.image = data / float(self.header["EXPTIME"])  # e/s
        # FITS (1-based) -> 0-based pixel convention
        self.header["CRPIX1"] = self.header["CRPIX1"] - 1
        self.header["CRPIX2"] = self.header["CRPIX2"] - 1
        self.wcs = wcsutils.SIPWCS.from_header(self.header, zero_based=True)
        date = self.header.get("DATE-OBS", "2025-01-01 00:00:00")
        self.date = re.sub(" ", "T", str(date)) + "Z"
        self.filter = str(self.header["FILTER"])[:4]
        self.ra_ = float(self.header["RA_TARG"])
        self.dec_ = float(self.header["DEC_TARG"])
        self.pa_ = float(self.header["PA_OBSY"])

    def charge_rate(self, pack, config=None, sky_rate=0.4, device=None):
        """Total charge rate in e/s on the active region (host float64):
        scene (through flat + pixel area + gain normalization, scaled by
        ``CNORM``) + sky (through the flat) + dark (cal preparation of
        ``sim_to_isim.py:615-662``; the dark and the flat are
        IPC-deconvolved on ``device`` when the CALDIR has a kernel)."""
        config = config or {}
        device = resolve_device(device)
        nside = pack.nside
        nb = pars.nborder
        na = nside - 2 * nb
        act = slice(nb, nside - nb)
        gain_act = pack.gain[act, act]
        dark_e = pack.dark_slope[act, act] * gain_act  # e/s
        flat = pack.flat[act, act]
        if pack.ipc_kernel is not None:
            kern = stage(pack.ipc_kernel, device)
            dark_e = ipc.ipc_rev(place(dark_e, device), kern).cpu().numpy()
            flat = ipc.ipc_rev(place(flat, device), kern,
                               gain=place(gain_act, device)).cpu().numpy()
            flat = np.clip(flat, 0.0, 2 - 2**-21)
            dark_e = np.clip(dark_e, -0.1 * flat, None)

        area = wcsutils.pixelarea(self.wcs, N=na, device=device).cpu().numpy()
        flat_witharea = flat / (area / pars.Omega_ideal)
        C = float(config.get("CNORM", 1.0))
        scene_rate = C * gain_act / pars.g_ideal * self.image * flat_witharea
        return np.clip(scene_rate + sky_rate * flat + dark_e, 0.0, None)

    def simulate(self, use_read_pattern, caldir=None, config=None, seed=43,
                 sky_rate=0.4, frame_time=None, persistence=None, device=None):
        """L1 (and idealized L2 inputs) simulation on ``device`` (default
        ``cuda``).

        Follows reference ``Image2D.simulate`` (``sim_to_isim.py:520-791``)
        with the romanisim blank-image step replaced by an explicit
        sky+dark Poisson rate (``sky_rate`` e/s/pix scaled by the flat).
        ``persistence``: optional (na, na) prior-exposure charge rate in
        e/s, forwarded to ``make_l1_fullcal``.
        """
        config = config or {}
        if caldir is None:
            raise ValueError(
                "caldir=None (romanisim internal defaults) is not supported; "
                "use synth.make_cal_files for a self-contained cal set"
            )
        device = resolve_device(device)
        pack = calfiles.load_caldir_cached(_caldir_files(caldir))
        ft = pars.read_time if frame_time is None else frame_time
        nside = pack.nside
        nb = pars.nborder
        gen = rand.sim_generator(seed, device)
        kernels = resolve_kernels(config, device)
        rate_e = self.charge_rate(pack, config, sky_rate, device)

        # L1 synthesis
        resultants, l1dq = make_l1_fullcal(
            gen, rate_e.astype(np.float32), use_read_pattern, pack,
            frame_time=ft, crparam={}, persistence=persistence,
            ipc_backend=kernels.ipc_fwd, contract=kernels.contract,
            lin_backend=kernels.lin,
        )

        no_amp33 = bool(caldir.get("NO_AMP33", False))
        cw = pack.amp33_med.shape[1] if pack.amp33_valid else max(nside // 32, 4)
        im, amp33 = fill_in_refdata_and_1f(
            gen, resultants, pack, use_read_pattern, nside, cw,
            fill_in_banding=True,
            amp33=(np.zeros(1) if (pack.amp33_valid and not no_amp33) else None),
            nborder=nb,
            pink_backend=kernels.pink,
        )
        with profiling.span(f"{_PREFIX}.to_host"):
            im_u16 = u16_to_host(im)
            amp33_u16 = u16_to_host(amp33) if amp33 is not None else None
            l1dq = to_numpy(l1dq, dq=True)
            # kept for make_ideal_l2: the reference's af2 is built from
            # the PRE-fill float cube (``sim_to_isim.py:745-754``) —
            # before banding noise, uint16 rounding, and EXTRACT_REF
            # reshuffling (which offset-shifts the DN the linearity
            # inversion sees)
            self._resultants_prefill = resultants.cpu().numpy()
        del im, amp33, resultants

        l1tree = {
            "meta": {
                "exposure": {
                    "read_pattern": [list(g) for g in use_read_pattern],
                    "frame_time": ft,
                    "nresultants": len(use_read_pattern),
                    "start_time": self.date,
                    "exposure_time": ft
                    * (use_read_pattern[-1][-1] - use_read_pattern[0][0]),
                },
                "instrument": {
                    "detector": f"WFI{self.idsca[1]:02d}",
                    "optical_element": "F" + self.filter[1:],
                },
                "pointing": {
                    "ra": self.ra_, "dec": self.dec_, "pa": self.pa_,
                },
                # SIP cards of the science-frame WCS (the reference
                # stamps pointing+wcsinfo into the L1 meta via romanisim
                # util.update_pointing_and_wcsinfo_metadata,
                # sim_to_isim.py:647); the sidecar text file remains the
                # parity surface for L1->L2
                "wcsinfo": dict(
                    self.wcs.to_cards(),
                    pixel_convention="0-based, active region",
                ),
            },
            "data": im_u16,
            "resultantdq": l1dq,
        }
        if amp33_u16 is not None:
            l1tree["amp33"] = amp33_u16
        if "EXTRACT_REF" in config:
            extract_reference_read(
                l1tree, int(config["EXTRACT_REF"].get("data_encoding_offset", 0)))

        self.af = asdf_lite.AsdfFile(
            {
                "roman": l1tree,
                "romanimpreprocess_tpu_torch": {"version": __version__},
            }
        )
        self.truth_rate = rate_e  # for validation
        self._read_pattern_sim = [list(g) for g in use_read_pattern]

    def L1_write_to(self, filename):
        if hasattr(self, "af"):
            self.af.write_to(filename)
            return True
        return False

    def make_ideal_l2(self, caldir, u=0.4 / 1.8 / 6.5**2, device=None):
        """Idealized L2 from the in-memory L1 (the reference's ``af2``
        from ``romanisim.image.make_l2``, ``sim_to_isim.py:745-789``):
        linearity-corrected Casertano slope, dark and flat removed, no
        jump machinery."""
        pack = calfiles.load_caldir_cached(_caldir_files(caldir))
        l1 = self.af["roman"]
        if hasattr(self, "_resultants_prefill"):
            # simulated in this process: use the PRE-fill float cube
            # (reference af2 semantics) with the full sim read pattern —
            # the file cube has banding + uint16 rounding and, under
            # EXTRACT_REF, per-pixel offset-shifted DN that would bias
            # the nonlinear inversion
            cube = self._resultants_prefill
            read_pattern = self._read_pattern_sim
        else:
            cube = np.asarray(l1["data"], np.float32)
            read_pattern = [
                list(g) for g in l1["meta"]["exposure"]["read_pattern"]
            ]
        slope = _ideal_slope(cube, read_pattern, l1, pack, u, device)
        self.af2 = asdf_lite.AsdfFile(
            {
                "roman": {
                    "meta": dict(l1["meta"]),
                    "data": slope,
                    "dq": (
                        # resultantdq is stored at active-region geometry
                        np.bitwise_or.reduce(
                            np.asarray(l1["resultantdq"], np.uint32), axis=0
                        )
                        if "resultantdq" in l1
                        else np.zeros(slope.shape, np.uint32)
                    ),
                },
                "romanimpreprocess_tpu_torch": {"version": __version__},
            }
        )
        return self.af2

    def L2_write_to(self, filename):
        """Write the idealized L2 (build it first with make_ideal_l2)."""
        if hasattr(self, "af2"):
            typefix.fix(self.af2.tree)
            self.af2.write_to(filename)
            return True
        return False


def extract_reference_read(l1tree, off):
    """EXTRACT_REF: move the reference read (resultant 0) out of the
    cube, in place (``sim_to_isim.py:711-730``).  The remaining
    resultants become differences from it, offset by ``off``
    (``data_encoding_offset``) and clipped to uint16; the amp33 block is
    treated alike."""
    exp = l1tree["meta"]["exposure"]
    l1tree["meta"]["instrument"]["data_encoding_offset"] = off
    exp["read_pattern"] = exp["read_pattern"][1:]
    exp["nresultants"] = exp["nresultants"] - 1
    l1tree["resultantdq"] = l1tree["resultantdq"][1:]
    for key, refkey in (("data", "reference_read"), ("amp33", "reference_amp33")):
        if key not in l1tree:
            continue
        cube = l1tree[key]
        l1tree[refkey] = cube[0].copy()
        modref = cube[0].astype(np.int32) - off
        l1tree[key] = np.clip(
            cube[1:].astype(np.int32) - modref[None], 0, 65535
        ).astype(np.uint16)


def _ideal_slope(cube, read_pattern, l1, pack, u, device=None):
    """Linearity-corrected Casertano slope of a (ngrp, n, n) cube on the
    active region, dark and clipped flat removed (float32 numpy).  The
    cube is at active-region or full-frame geometry."""
    device = resolve_device(device)
    nb = pars.nborder
    nside = pack.nside
    act = slice(nb, nside - nb)
    ft = float(l1["meta"]["exposure"].get("frame_time", pars.read_time))
    full = cube.shape[-1] == nside
    lin = _staged_lin(pack, device, slice(None) if full else act)
    meta = ramp.ma_table_meta(read_pattern, ft)
    exclude_first = read_pattern[0] == [0]
    lin_cube, _ = linearity.apply_linearity_cube(
        stage(cube, device, cache=False).to(torch.float32), lin,
        do_not_flag_first=exclude_first)
    K = ramp.casertano_weights(u, meta, exclude_first)
    slope = np.einsum("t,tij->ij", K, lin_cube.cpu().numpy())
    if full:
        slope = slope[act, act]
    slope = slope - pack.dark_slope[act, act]
    return (slope / np.clip(pack.flat[act, act], 0.1, 10.0)).astype(np.float32)


class Image2D_from_L1(Image2D):
    """Shortcut workflow: a 2-D image constructed from an L1 data file
    (reference ``Image2D_from_L1:837-944``).  For production use the
    full ``l1_to_l2`` pipeline; this is the idealized pass-through.
    """

    def __init__(self, infile, caldir, thewcs=None):
        self.af = asdf_lite.open(infile)
        self.caldir = caldir
        self.thewcs = thewcs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def pseudocalibrate(self, u=0.4 / 1.8 / 6.5**2, device=None):
        """Idealized L2: linearity-corrected Casertano slope fit, no
        reference-pixel/IPC/jump machinery (the romanisim ``make_l2``
        analog used by the reference's shortcut path).
        """
        if self.thewcs is not None and not isinstance(
            self.thewcs, fits_lite.Header
        ):
            raise ValueError("Unrecognized WCS")
        pack = calfiles.load_caldir(_caldir_files(self.caldir))
        l1 = self.af["roman"]
        read_pattern = [list(g) for g in l1["meta"]["exposure"]["read_pattern"]]
        slope = _ideal_slope(np.asarray(l1["data"], np.float32), read_pattern,
                             l1, pack, u, device)
        self.af2 = asdf_lite.AsdfFile(
            {
                "roman": {
                    "meta": dict(l1["meta"]),
                    "data": slope,
                    "dq": np.zeros(slope.shape, np.uint32),
                },
                "romanimpreprocess_tpu_torch": {"version": __version__},
            }
        )
        return self.af2


def run_config(config, device=None):
    """Config-driven sim -> L1 (reference ``run_config:947-997``) on
    ``device`` (default ``cuda``; raises without a GPU).

    Writes the L1 ASDF, the FITS-WCS sidecar header, and optionally a
    FITS viewing copy with the amp33 block appended.
    """
    device = resolve_device(device)
    caldir = config.get("CALDIR", None)
    use_read_pattern = reads_to_pattern(config["READS"])
    seed = int(config.get("SEED", 43))

    # optional prior-exposure persistence rate image (e/s), FITS file
    # (analog of the Persistence threading in sim_to_isim.py:924-928)
    persistence = None
    if config.get("PERSISTENCE"):
        persistence = np.asarray(
            fits_lite.open_fits(config["PERSISTENCE"])[0].data, np.float32
        )

    x = Image2D("anlsim", fname=config["IN"])
    # sky background: metadata-driven by default (filter + pointing +
    # date zodiacal model + thermal floor, like romanisim's
    # simulate_counts background path, reference sim_to_isim.py:596,637);
    # SKY_RATE overrides with an explicit e/s/pix scalar
    if "SKY_RATE" in config:
        sky_rate = float(config["SKY_RATE"])
    else:
        sky_rate = skymodel.sky_background_rate(
            x.filter, x.ra_, x.dec_, x.date
        )
    x.simulate(
        use_read_pattern, caldir=caldir, config=config, seed=seed,
        sky_rate=sky_rate,
        frame_time=config.get("FRAME_TIME"),
        persistence=persistence, device=device,
    )
    x.L1_write_to(config["OUT"])

    # WCS sidecar (FITS-card text; CRPIX already 0-based per Image2D)
    hdr = x.header.copy()
    hdr["COMMENT"] = "truth wcs from sim_to_l1"
    hdr.tofile(config["OUT"][:-5] + "_asdf_wcshead.txt", overwrite=True)

    if config.get("FITSOUT", False):
        roman = x.af["roman"]
        data = roman["data"]
        if "amp33" in roman:
            out = np.concatenate([data, roman["amp33"]], axis=2)
        else:
            out = data
        fits_lite.PrimaryHDU(out).writeto(
            config["OUT"][:-5] + "_asdf_to.fits", overwrite=True
        )
    return x


def main(argv=None):
    ap = argparse.ArgumentParser(description="sim -> L1 of one SCA")
    ap.add_argument("config", help="YAML config (IN, OUT, READS, CALDIR, ...)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    run_config(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
