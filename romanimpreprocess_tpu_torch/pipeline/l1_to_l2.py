"""L1 -> L2 calibration: the ``gen_cal_image`` equivalent, in PyTorch.

Re-implements the full calibration chain of the reference pipeline
(``src/romanimpreprocess/L1_to_L2/gen_cal_image.py:480-739``) as one
device function over tensors plus a thin host wrapper:

device core (the cube never leaves the device):
  dq init -> saturation flagging -> per-group reference-pixel
  correction (row + channel, amp33 optimal slope) -> bias correction ->
  dark-decay / WFI18-transient corrections -> Legendre linearity ->
  IPC deconvolution -> ramp fit + jump detection -> dark-current
  subtraction -> flat field / pixel area -> sky mode + optional
  Legendre sky subtraction -> endslice map.

host wrapper: YAML config, L1 ASDF read, CALDIR load (once), WCS
sidecar -> pixel-area map, plan precomputation, staging onto the
device, L2 ASDF/FITS write, process log.

While a ``torch.profiler`` records, the host wrapper's steps are spans
of :mod:`..utils.profiling` named ``host.<step>`` (``host.calibrate``,
``host.prepare`` with ``.plan`` and ``.medgain``, ``host.stage``,
``host.ipc_precal``, ``host.to_host``, ``host.package`` with ``.maps``,
``.refdata`` and ``.meta``), the core's stages spans named
``l1_to_l2.<stage>``, and the copies (:mod:`..io.staging`) are counted
(``h2d_bytes``, ``d2h_bytes``, ``gather_bytes``).

The device core's stages (:func:`calibrate_rows`) take row slabs of the
frame with their halos; :func:`make_core` runs them on the whole frame,
:mod:`..parallel.spatial` on the slabs of a row-sharded frame.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`..config.resolve_device`).  The ``IPC_BACKEND``,
``LIN_BACKEND`` and ``SKY_BACKEND`` keys choose between the
hand-written CUDA kernels and their plain PyTorch versions
(:func:`..config.resolve_kernels`, once in :func:`prepare_inputs`; the
IPC inverse has a frame kernel and a slab kernel).
``romancal_ramp_fit: True`` swaps the ramp fit for the likelihood
fitter (:mod:`..ops.likely`), which adds ``dumo`` and ``chisq`` to the
product.  DQ planes are int32 bit patterns on the device and uint32
numpy arrays in the L2 tree.
"""

import argparse
import os
import time

import numpy as np
import torch

from .. import pars
from ..config import load_config, resolve_device, resolve_kernels
from ..dqflags import group as gdq
from ..dqflags import i32, pixel
from ..io import asdf_lite, calfiles, fits_lite
# called through these names, which ``gpubench/entries`` wraps (and clears)
from ..io.staging import _DEVICE_CACHE, send, stage, to_host  # noqa: F401
from ..ops import (ipc, ipc_cuda, ipc_slab, likely, linearity,
                   linearity_cuda, mask, ramp, refsub, saturation, sky,
                   wcsutils)
from ..ops.sky import full_fp32
from ..utils import hostcache, profiling, typefix
from ..utils.processlog import ProcessLog
from ..utils.rows import Rows
from . import oututils


# --------------------------------------------------------------------------
# Device core
# --------------------------------------------------------------------------

def _dark_decay_signal(read_pattern, frame_time, amplitude, time_constant):
    """Per-resultant additive decay signal s_j = A * mean_r exp(-t_r/tau)
    (host numpy; the sim stage injects the identical model)."""
    out = []
    for grp in read_pattern:
        ts = np.array(grp, dtype=np.float64) * frame_time
        out.append(amplitude * np.mean(np.exp(-ts / time_constant)))
    return np.asarray(out, dtype=np.float32)


#: Default core output set = exactly what the L2 product consumes
#: (``package_tree``).  The full group DQ ``rdq`` and the applied
#: ``flat`` map are diagnostics the product never carries; request them
#: with ``cfg["outputs"] = (..., "rdq", "flat")``.
PRODUCT_OUTPUTS = (
    "slope", "slope_withsky", "slope_err_read", "slope_err_poisson",
    "pdq", "medsky", "skycoefs", "endslice",
)

WFI18_DEFAULT_TAUS = (150.0, 1300.0)

#: ``th`` of the pre-padded slab kernel planes the slab IPC routes stage
#: (the reference's choice; here it only names the buffer's geometry)
SLAB_TH = 32
#: the core's IPC routes that read ``arr["ipc_kernel_padded"]``: the slab
#: kernel's two entry points and their plain twin ('slab-plain' is set
#: only by tests and checks on ``prep["cfg"]["ipc"]``; no config key
#: selects it)
SLAB_ROUTES = ("slab", "slab-stream", "slab-plain")


def _wfi18_row_basis(nside, taus=WFI18_DEFAULT_TAUS):
    """Two-exponential row basis (nside, len(taus)) for the first-read
    transient; the row coordinate includes the 4-row timing gap every
    256 rows."""
    rows = np.arange(nside, dtype=np.float64)
    reff = rows + (rows // 256) * 4
    basis = np.stack([np.exp(-reff / t) for t in taus], axis=1)
    return basis.astype(np.float32)


def _add_active(x, y, act):
    """A copy of the 2-D ``x`` with ``y`` added on ``x[act]``."""
    out = x.clone()
    out[act] += y
    return out


def _gather(pieces, lead, dim=-2):
    """The pieces, in row order, as one tensor on ``lead`` (one piece is
    returned as it is); the bytes go on the ``gather_bytes`` counter."""
    if len(pieces) == 1:
        return pieces[0]
    profiling.count("gather_bytes", sum(p.nbytes for p in pieces))
    return torch.cat([p.to(lead) for p in pieces], dim=dim)


class _Slab:
    """One slab's state through the stages: its staged arrays ``arr``
    (for the rows ``at``), the rows its state tensors hold now
    (``rows``: ``at`` until the halo is trimmed), and the state."""

    def __init__(self, arr, rows, nside, nb):
        self.arr, self.at, self.rows = arr, rows, rows
        self.nside, self.nb = nside, nb
        self.data = arr["data"]
        self.dev = self.data.device
        self.cols = slice(nb, nside - nb)

    @property
    def act(self):
        """(rows, columns) of the state tensors on the frame's active region."""
        return self.rows.active(self.nside, self.nb), self.cols

    def full(self, k):
        """The full-height array ``k`` at the state's rows."""
        v = self.arr[k]
        if self.rows == self.at:
            return v
        d = self.rows.y0 - self.at.y0
        return v[..., d : d + self.rows.n, :]

    def active(self, k):
        """The active-height array ``k`` at the state's active rows."""
        v = self.arr[k]
        if self.rows == self.at:
            return v
        now = self.rows.active_span(self.nside, self.nb)
        d = self.at.active_span(self.nside, self.nb).start
        return v[..., now.start - d : now.stop - d, :]

    def own_rows(self, t, dim=-2):
        """The own rows of a state tensor whose rows are axis ``dim``
        (-2: a frame or cube, -1: a vector per row)."""
        own = self.rows.own
        if self.rows.lo == self.rows.hi == 0:
            return t
        return t[..., own, :] if dim == -2 else t[..., own]

    def trim(self, data_trimmed=False):
        """Drop the halo rows from the state."""
        if not data_trimmed:
            self.data = self.own_rows(self.data)
        self.rdq = self.own_rows(self.rdq)
        self.pdq = self.own_rows(self.pdq)
        self.rows = self.rows.trimmed()

    def interior(self):
        """The frame's interior (by nborder) at the state's rows."""
        m = torch.zeros((self.rows.n, self.nside), dtype=torch.bool, device=self.dev)
        m[self.act] = True
        return m


def _take_rows(slabs, tensors, a, b, lead):
    """Frame rows ``[a, b)`` of per-slab state tensors (..., rows, nx),
    from the slabs' own rows, as one tensor on ``lead``."""
    pieces = []
    for s, t in zip(slabs, tensors):
        own = s.rows.trimmed()
        i0, i1 = max(a, own.y0), min(b, own.y0 + own.n)
        if i1 > i0:
            pieces.append(t[..., i0 - s.rows.y0 : i1 - s.rows.y0, :])
    return _gather(pieces, lead)


def _saturation(s, cfg, ab):
    """dq initialization (romancal do_dqinit analog) and saturation."""
    s.pdq = s.full("mask_dq")
    s.rdq = torch.zeros(s.data.shape, dtype=torch.int32, device=s.dev)
    if cfg["exclude_first"]:
        s.rdq[0] |= i32(gdq.DO_NOT_USE)
    if "saturation" not in ab:
        s.rdq, s.pdq = saturation.flag_saturation(
            s.data, s.rdq, s.pdq, s.full("saturation"), s.full("saturation_dq"),
            backup=cfg["backup"], skip_first=1, n_pix_grow_sat=1,
        )


def _refpix(slabs, cfg, geom, lead):
    """Per-group reference-pixel correction (reference
    ``gen_cal_image.py:531-556``): dark-subtracted frame (+ amp33
    reference block), row subtraction with the optimal amp33 slope,
    then channel subtraction; dark re-added afterwards.  All groups at
    once.  The medians of each row are the slab's; what spans the rows
    (the row fit, the amp33 block's median, the channel lines from the
    frame's edge rows) is computed on ``lead`` from the gathered rows.
    """
    nside, nb, channelwidth = geom
    work = [s.data - s.full("dark_cube") for s in slabs]
    # ---- row stage (reference_subtraction.py:77-125) ----
    if cfg["use_amp33"]:
        amp33 = _gather([s.own_rows(s.full("amp33")) for s in slabs], lead)
        amp33_med = _gather([s.own_rows(s.full("amp33_med")) for s in slabs], lead)
        ngrp = amp33.shape[0]
        blk = amp33 - amp33_med
        blk = blk - refsub.median(blk.reshape(ngrp, -1), dim=-1)[:, None, None]
        ref_med = refsub.median(blk, dim=-1)  # (ngrp, nside)
        ctr = refsub.median(ref_med, dim=-1)[:, None]
        for i, s in enumerate(slabs):
            rm = ref_med[:, s.rows.y0 : s.rows.y0 + s.rows.n].to(s.dev)
            work[i] = work[i] - (s.arr["opt_slope"] * (rm - ctr.to(s.dev)))[..., None]
    else:
        meds = [refsub.row_medians(w, nside, nb) for w in work]
        m, ctr = refsub.row_coefs(
            _gather([s.own_rows(sm, -1) for s, (sm, _) in zip(slabs, meds)], lead, -1),
            _gather([s.own_rows(rm, -1) for s, (_, rm) in zip(slabs, meds)], lead, -1))
        for i, s in enumerate(slabs):
            work[i] = refsub.row_apply(work[i], meds[i][1], m.to(s.dev), ctr.to(s.dev))
    # ---- channel stage (reference_subtraction.py:16-74) ----
    m, c = refsub.channel_line(_take_rows(slabs, work, 0, nb, lead),
                               _take_rows(slabs, work, nside - nb, nside, lead),
                               nside, nside, nb, channelwidth)
    for w, s in zip(work, slabs):
        s.data = refsub.channel_apply(w, m.to(s.dev), c.to(s.dev), channelwidth,
                                      row0=s.rows.y0) + s.full("dark_cube")


def _wfi18(slabs, geom, lead):
    """Fit & subtract the exponential row profile from the first read.

    Row medians of (read0 - read1) isolate the transient (each slab's
    own rows); least squares on the fixed-tau basis gives the
    amplitudes (on ``lead``, over every row); the fitted profile is
    removed from read 0.
    """
    nside, nb, _ = geom
    cols = slice(nb, nside - nb)
    prof = _gather([refsub.median(s.data[0, s.rows.own, cols] - s.data[1, s.rows.own, cols],
                                  dim=-1) for s in slabs], lead, -1)
    basis = _gather([s.own_rows(s.full("wfi18_basis")) for s in slabs], lead)
    prof = prof - refsub.median(prof)
    with full_fp32():
        BtB = basis.T @ basis
        coef = torch.linalg.solve(BtB, basis.T @ prof)
        model = basis @ coef
    for s in slabs:
        out = s.data.clone()
        out[0] -= model[s.rows.y0 : s.rows.y0 + s.rows.n, None].to(s.dev)
        s.data = out


def _linearity(s, cfg):
    lin = linearity.LinearityData(
        s.full("lin_coefs"), s.full("lin_smin"), s.full("lin_smax"),
        s.full("lin_sref"), s.full("lin_dq"),
    )
    attempt = (s.rdq & i32(gdq.SATURATED)) == 0
    if cfg["lin"] == "cuda":
        s.data, dq_lin = linearity_cuda.apply_linearity_cube_fused(
            s.data.contiguous(), lin, attempt,
            do_not_flag_first=cfg["first_is_reset"],
        )
    else:
        s.data, dq_lin = linearity.apply_linearity_cube(
            s.data, lin, do_not_flag_first=cfg["first_is_reset"],
            attempt_corr=attempt,
        )
    s.pdq = s.pdq | dq_lin


def _ipc(s, route):
    """Order-2 inverse on the active region, border passthrough, on the
    slab with its halo; the result is the slab's own rows."""
    nb, r = s.nb, s.rows
    if route in SLAB_ROUTES:
        # the slab routes: y = active * gain, (3y - 3Ky) + K Ky,
        # / gain, merged into the frame
        fn = {"slab": ipc_slab.correct_cube_fused,
              "slab-stream": ipc_slab.correct_cube_stream,
              "slab-plain": ipc_slab.correct_cube_plain}[route]
        s.data = fn(s.data.contiguous(), s.arr["ipc_kernel_padded"], s.full("gain")[s.act],
                    nb, SLAB_TH, r.y0, r.lo, r.hi)
    else:
        fn = ipc_cuda.ipc_rev2_rows if route == "cuda" else ipc_cuda.ipc_rev2_rows_plain
        s.data = fn(s.data.contiguous(), s.full("ipc_kernel_frame"), s.full("gain"), nb,
                    r.y0, r.lo, r.hi)


def _ramp(s, plan, cfg):
    fit = likely.ramp_fit_likely if cfg["likelihood_fit"] else ramp.ramp_fit
    res = fit(s.data, s.rdq, s.pdq, plan, s.full("gain"), s.full("read_sigma"),
              nborder=s.nb, interior=s.interior())
    s.slope, s.ser, s.sep, s.rdq, s.pdq = res[:5]
    s.dumo, s.chisq = res[5:] if cfg["likelihood_fit"] else (None, None)


def _dark_flat(s, cfg, has_ipc):
    """Dark current (IPC-corrected dark slope), border zeroing, flat
    field (reference flatutils.get_flat + area factor)."""
    act = s.act
    zero = torch.zeros((), dtype=torch.int32, device=s.dev)
    if has_ipc:
        s.slope = _add_active(s.slope, -s.active("dark_slope_ipc"), act)
    else:
        s.slope = _add_active(s.slope, -s.full("dark_slope")[act], act)
    if cfg["has_dark_dq"]:
        s.pdq = s.pdq | s.full("dark_dq")

    # zero the border of the science/variance maps (reference
    # do_ramp_fit re-embedding, gen_cal_image.py:470-475)
    interior = s.interior()
    fzero = torch.zeros((), dtype=torch.float32, device=s.dev)
    s.slope = torch.where(interior, s.slope, fzero)
    s.ser = torch.where(interior, s.ser, fzero)
    s.sep = torch.where(interior, s.sep, fzero)

    flat = torch.ones((s.rows.n, s.nside), dtype=torch.float32, device=s.dev)
    flat[act] = s.full("flat")[act]
    s.pdq = s.pdq | torch.where((flat < 0.1) | (flat > 10.0),
                                i32(pixel.NO_FLAT_FIELD), zero)
    flat = torch.clamp(flat, 0.1, 10.0)
    if has_ipc:
        no_gain = torch.zeros((s.rows.n, s.nside), dtype=torch.bool, device=s.dev)
        no_gain[act] = s.full("gain")[act] <= 0.1
        s.pdq = s.pdq | torch.where(no_gain, i32(pixel.NO_GAIN_VALUE), zero)
        flat[act] = s.active("flat_ipc")
    s.flat = flat / s.full("area_factor")
    s.slope = s.slope / s.flat
    s.ser = s.ser / s.flat
    s.sep = s.sep / s.flat


def _sky(slabs, cfg, ab, geom, lead, stage):
    """Sky mode (PixelMask1, 4 x 4 bins) and the medfit Legendre sky,
    on the whole frame's slope and pixel DQ gathered on ``lead``; each
    slab subtracts its rows of the model.  Returns (medsky, skycoefs)
    on ``lead``."""
    nside, nb, _ = geom
    do_mode = "sky" not in ab and "smooth" not in ab
    do_fit = cfg["skyorder"] >= 0 and "sky" not in ab and "medfit" not in ab
    for s in slabs:
        s.slope_withsky = s.slope
    slope = _gather([s.slope for s in slabs], lead) if do_mode or do_fit else None
    if do_mode:
        m = mask.PixelMask1.build(_gather([s.pdq for s in slabs], lead))
        nan = torch.full((), float("nan"), dtype=torch.float32, device=lead)
        medsky, _ = sky.smooth_mode(
            sky.binkxk(torch.where(~m, slope, nan), 4)
        )
    else:
        medsky = torch.zeros((), dtype=torch.float32, device=lead)
    stage("sky_fit")
    if do_fit:
        act = slice(nb, nside - nb)
        skycoefs, skymodel = sky.medfit(
            slope[act, act], order=cfg["skyorder"], backend=cfg["med"],
        )
        for s in slabs:
            s.slope = _add_active(
                s.slope, -skymodel[s.rows.active_span(nside, nb)].to(s.dev), s.act)
    else:
        skycoefs = torch.zeros(0, dtype=torch.float32, device=lead)
    return medsky, skycoefs


def calibrate_rows(parts, plan, cfg, geom):
    """The calibration core on the row slabs of one frame.

    ``parts`` is a list of ``(arr, rows)`` in row order: each slab's
    array bundle (full-height arrays at the frame rows ``rows``,
    active-height ones at their active rows, metadata-scale ones whole)
    and its :class:`Rows`.  The stages run slab after slab from this
    thread; each slab's tensors stay on its device.  Per-pixel stages
    and the per-row medians are the slab's own; the halo rows feed the
    3 x 3 saturation grow and the IPC inverse and are trimmed after it;
    what spans rows (the refpix fit and channel lines, the WFI18 fit,
    the sky) is computed once on the first slab's device from gathered
    rows (counted as ``gather_bytes``, :mod:`..utils.profiling`) and
    sent back.  One part holding the
    whole frame (``Rows(0, nside)``) is the single-SCA core of
    :func:`make_core`.  Returns one output dict per slab: its own rows,
    ``endslice`` its active rows, ``medsky`` / ``skycoefs`` the same on
    every slab.
    """
    nside, nb, _ = geom
    # diagnostic stage ablation: names in cfg["ablate"] are skipped
    ab = cfg.get("ablate", ())
    has_ipc = cfg["has_ipc"] and "ipc" not in ab
    slabs = [_Slab(arr, rows, nside, nb) for arr, rows in parts]
    lead = slabs[0].dev
    ngrp = slabs[0].data.shape[0]

    stage = profiling.StageRanges("l1_to_l2")
    stage("saturation")
    for s in slabs:
        _saturation(s, cfg, ab)
    stage("refpix")
    if "refpix" not in ab:
        _refpix(slabs, cfg, geom, lead)

    stage("bias_decay_wfi18")
    for s in slabs:
        if cfg["has_biascorr"]:
            s.data = s.data.clone()
            s.data[(slice(None),) + s.act] -= s.active("biascorr")
        if cfg["has_dark_decay"]:
            s.data = s.data - s.arr["dark_decay_signal"][:, None, None]
    if cfg["wfi18"]:
        _wfi18(slabs, geom, lead)

    stage("linearity")
    if "linearity" not in ab:
        for s in slabs:
            _linearity(s, cfg)

    if has_ipc:
        stage("ipc_slab" if cfg["ipc"] in SLAB_ROUTES else "ipc")
    for s in slabs:
        if has_ipc:
            _ipc(s, cfg["ipc"])
        s.trim(has_ipc)

    stage("ramp_fit_likely" if cfg["likelihood_fit"] else "ramp_fit")
    for s in slabs:
        _ramp(s, plan, cfg)

    stage("dark_flat")
    for s in slabs:
        _dark_flat(s, cfg, has_ipc)

    stage("sky_mode")
    medsky, skycoefs = _sky(slabs, cfg, ab, geom, lead, stage)

    stage("endslice")
    outs = []
    for s in slabs:
        firstsat = ramp.first_saturated_group(s.rdq)[s.act]
        out = {
            "slope": s.slope,
            "slope_withsky": s.slope_withsky,
            "slope_err_read": s.ser,
            "slope_err_poisson": s.sep,
            "pdq": s.pdq,
            "rdq": s.rdq,
            "flat": s.flat,
            "medsky": medsky.to(s.dev),
            "skycoefs": skycoefs.to(s.dev),
            "endslice": torch.where(
                firstsat < ngrp, firstsat - 1, torch.full_like(firstsat, -1)
            ).to(torch.int8),
        }
        if s.dumo is not None:
            # dumo is slope-like -> flat-field it (gen_cal_image.py:671)
            out["dumo"] = s.dumo / s.flat
            out["chisq"] = s.chisq
        # the default is the product contract: PRODUCT_OUTPUTS plus the
        # likelihood diagnostics
        keys = cfg.get("outputs") or (
            PRODUCT_OUTPUTS + (("dumo", "chisq") if s.dumo is not None else ())
        )
        outs.append({k: out[k] for k in keys})
    stage.close()
    return outs


def make_core(plan, cfg, geom):
    """Build the calibration core for one (MA table, config).

    ``cfg`` is the dict of static choices from :func:`prepare_inputs`;
    ``geom`` = (nside, nborder, channelwidth).  Returns a function from
    the device array bundle to a dict of device tensors:
    :func:`calibrate_rows` on the whole frame.
    """
    whole = Rows(0, geom[0])

    def core(arr):
        return calibrate_rows([(arr, whole)], plan, cfg, geom)[0]

    return core


# --------------------------------------------------------------------------
# Host side
# --------------------------------------------------------------------------

# the IPC precal of each cal pack and device, held with the pack on the
# device: io.staging's cache, bounded by the card's bytes, in which a
# focal plane's 18 packs stay resident together (the name is the one the
# benchmark clears)
_IPC_PRECAL_CACHE = _DEVICE_CACHE


def ipc_precal(flat, dark_slope, gain, ipc_kernel, nborder, device, pack=None):
    """IPC-deconvolved dark-slope and clipped-flat planes.

    The dark-slope and flat frames go through the same order-2 IPC
    inverse as the data cube (reference ``subtract_dark_current``
    IPC-corrects the dark ref first, ``gen_cal_image.py:217-221``;
    ``get_flat`` deconvolves the flat, ``flatutils.py:61-74``).  Both
    are exposure-independent, so they are computed once per cal pack
    and device (id-keyed cache; held with the cal pack whose lookup
    ``pack`` is, else loose) with :func:`..ops.ipc.ipc_rev`.

    Returns ``(dark_slope_ipc, flat_ipc)``, active-region (na, na)
    float32 tensors on ``device``: unclipped gain for the dark slope,
    gain clipped to >= 0.1 for the flat.  A cache miss is the span
    ``host.ipc_precal``; what it copies to the device counts
    ``pack_staged_bytes`` (the IPC kernel too, which is not kept).
    """
    nb = nborder
    device = torch.device(device)
    ck = (id(flat), id(dark_slope), id(gain), id(ipc_kernel), nb, str(device))
    hit = _IPC_PRECAL_CACHE.get(ck, pack=pack)
    if hit is not None:
        return hit[0]
    with profiling.span("host.ipc_precal"):
        gain_act = np.asarray(gain[nb:-nb, nb:-nb], np.float32)
        gain_flat = np.clip(gain_act, 0.1, None)
        flat_clipped = np.clip(
            np.asarray(flat[nb:-nb, nb:-nb], np.float32), 0.1, 10.0
        )
        dslope_act = np.asarray(dark_slope[nb:-nb, nb:-nb], np.float32)
        stacked = np.stack([dslope_act * gain_act, flat_clipped * gain_flat])
        kernel = stage(ipc_kernel, device, cache=False)
        corr = ipc.ipc_rev(send(torch.from_numpy(stacked), device), kernel)
        out = (corr[0] / send(torch.from_numpy(gain_act), device),
               corr[1] / send(torch.from_numpy(gain_flat), device))
    profiling.count("pack_staged_bytes", stacked.nbytes + 2 * gain_act.nbytes + kernel.nbytes)
    return _IPC_PRECAL_CACHE.put(
        ck, (out, (flat, dark_slope, gain, ipc_kernel)),
        sum(t.nbytes for t in out), device, pack=pack,
    )[0]


def _pack_planes(kind, kernel, build, device, pack):
    """A cal pack's kernel planes (``build()``, host) on ``device``, held
    with the pack (:data:`_DEVICE_CACHE`, keyed by the kernel's ``id``,
    ``kind`` and device).  The host planes are built on a miss only, and
    not kept; the copy counts ``pack_staged_bytes``."""
    ck = (id(kernel), kind, str(device))
    hit = _DEVICE_CACHE.get(ck, pack=pack)
    if hit is not None:
        return hit[0]
    planes = build()
    t = stage(planes, device, cache=False)
    profiling.count("pack_staged_bytes", planes.nbytes)
    return _DEVICE_CACHE.put(ck, (t, kernel), t.nbytes, device, pack=pack)[0]


# a host float per gain array; cap 25 > the 18-SCA focal plane, so
# under the focal plane's rotation every pack's stays
_MEDGAIN_CACHE = hostcache.BoundedCache(25, "medgain")


def median_gain(gain):
    """The cal pack's median gain (e/DN), ``float(np.median(gain))``, for
    the L2 metadata (``meta.gain``, ``processinfo.medgain``).

    Worked out once per gain array: the cache is keyed by ``id(gain)``
    and its value holds the array, so a recycled id cannot alias.  As
    for :func:`stage` and :func:`ipc_precal`, a cal pack's arrays must
    not be written in place.
    """
    hit = _MEDGAIN_CACHE.get(id(gain))
    if hit is not None:
        return hit[0]
    return _MEDGAIN_CACHE.put(id(gain), (float(np.median(gain)), gain))[0]


_WCS_CACHE = hostcache.BoundedCache(65, "wcs")


def wcs_from_config(config):
    """FITS-header WCS from the FITSWCS sidecar (reference
    ``gen_cal_image.py:64-87``), memoized by (path, mtime)."""
    if "FITSWCS" not in config:
        return None
    path = config["FITSWCS"]
    key = (path, os.path.getmtime(path))
    hit = _WCS_CACHE.get(key)
    if hit is not None:
        return hit
    with open(path) as f:
        hdr = fits_lite.Header.fromstring(f.read())
    return _WCS_CACHE.put(key, hdr)


def calibrateimage(config, verbose=False, return_arrays=False, device=None):
    """Run the L1->L2 calibration per the config dict; write the L2 ASDF.

    Config keys follow the reference (``docs/L1_to_L2_README.rst``):
    IN, OUT, CALDIR, FITSWCS, RAMP_OPT_PARS, JUMP_DETECT_PARS, SKYORDER,
    EXCLUDE_FIRST, SATURATION_BACKUP, SLICEOUT, FITSOUT,
    correct_wfi18_transient, romancal_ramp_fit (with REJECTION_THRESHOLD
    and JUMP_KW), and the ``*_BACKEND`` kernel choices.
    Runs on ``device`` (default ``cuda``; raises without a GPU).
    """
    device = resolve_device(device)
    pack = calfiles.load_caldir_cached(config["CALDIR"])
    l1 = asdf_lite.open(config["IN"])["roman"]
    area_factor = area_factor_from_config(config, pack.nside)
    tree, out = calibrate_tree(l1, config, pack, area_factor, device=device)
    typefix.fix(tree)  # schema-compat dummy fields (reference writes them)
    asdf_lite.AsdfFile(tree).write_to(config["OUT"])

    if config.get("FITSOUT", False):
        im2 = tree["roman"]
        good = ~mask.PixelMask1.build(im2["dq"]).numpy()
        fits_lite.HDUList(
            [
                fits_lite.PrimaryHDU(im2["data"]),
                fits_lite.ImageHDU(im2["dq"]),
                fits_lite.ImageHDU(np.where(good, im2["data"], -1000.0)),
            ]
        ).writeto(config["OUT"][:-5] + "_asdf_to.fits", overwrite=True)

    if verbose:
        print(tree["processinfo"]["log"])
    if return_arrays:
        return out
    return None


def area_factor_from_config(config, nside):
    """FITSWCS sidecar -> pixel-area / Omega_ideal map (unit if absent)."""
    thewcs = wcs_from_config(config)
    if thewcs is None:
        return np.ones((nside, nside), dtype=np.float32)
    w = wcsutils.SIPWCS.from_header(thewcs, zero_based=True)
    return (wcsutils.pixelarea(w, N=nside) / pars.Omega_ideal).astype(np.float32)


@profiling.span("host.calibrate")
def calibrate_tree(l1, config, pack, area_factor=None, verbose=False,
                   device=None):
    """Calibrate an in-memory L1 tree; return (L2 tree, core outputs as
    numpy)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    prep = prepare_inputs(l1, config, pack, area_factor, device=device)
    t1 = time.perf_counter()
    core = make_core(prep["plan"], prep["cfg"], prep["geom"])
    out = to_host(core(prep["arr"]))
    t2 = time.perf_counter()
    prep = dict(
        prep,
        log=prep["log"]
        + f"Timing: host prepare {1e3 * (t1 - t0):.1f} ms; "
        f"core device+transfer {1e3 * (t2 - t1):.1f} ms on {device}\n",
    )
    tree = package_tree(out, prep, l1, config)
    if verbose:
        print(tree["processinfo"]["log"])
    return tree, out


def _guide_window_rows(l1meta, config, nside, expand=1):
    """Boolean (nside,) mask of rows affected by the guide-window read
    (romancal ``do_dqinit`` with ``expand_gw_flagging=1``), from
    ``config["GUIDE_WINDOW"] = [ystart, ystop)`` or the L1 meta
    ``guide_star.gw_window_ystart / gw_window_ystop``; None when absent.
    """
    bounds = config.get("GUIDE_WINDOW")
    if bounds is None:
        gs = l1meta.get("guide_star")
        if gs is None or "gw_window_ystart" not in gs:
            return None
        bounds = (gs["gw_window_ystart"], gs["gw_window_ystop"])
    y0, y1 = int(bounds[0]), int(bounds[1])
    rows = np.zeros(nside, dtype=bool)
    rows[max(y0 - expand, 0):min(y1 + expand, nside)] = True
    return rows


@profiling.span("host.prepare")
def prepare_inputs(l1, config, pack, area_factor=None, device=None):
    """Host-side preparation: plan, static cfg, and the array bundle for
    one SCA, staged onto ``device`` (default ``cuda``).  Returns a dict;
    ``arr`` holds tensors, cal-pack arrays staged once per device;
    ``kernels`` the :func:`..config.resolve_kernels` that ``cfg`` reads.

    The cal pack's arrays, its IPC precal and its kernel planes are one
    lookup of :data:`_DEVICE_CACHE`: held on the device whole, or (where
    the card's budget does not hold the pack) staged for this call
    only (:class:`..utils.hostcache.PackCache`)."""
    device = resolve_device(device)
    mylog = ProcessLog()
    caldir = config["CALDIR"]
    nside = pack.nside
    nborder = pars.nborder
    nb = nborder
    if area_factor is None:
        area_factor = np.ones((nside, nside), dtype=np.float32)

    l1meta = l1["meta"]
    data = np.asarray(l1["data"])
    ngrp = data.shape[0]
    read_pattern = [list(g) for g in l1meta["exposure"]["read_pattern"]]
    frame_time = float(l1meta["exposure"].get("frame_time", pars.read_time))
    detector = str(l1meta.get("instrument", {}).get("detector", "WFI00"))
    channelwidth = (
        np.asarray(l1["amp33"]).shape[-1] if "amp33" in l1
        else max(nside // 32, 4)
    )
    mylog.append("Initialized data\n")

    meta = ramp.ma_table_meta(read_pattern, frame_time)
    meta["nborder"] = nborder

    exclude_first = bool(config.get("EXCLUDE_FIRST", True))
    backup = int(config.get("SATURATION_BACKUP", 1))

    # ---- guide-window DQ flagging (host side; per-exposure metadata) ----
    mask_dq = pack.mask_dq if pack.mask_dq is not None else np.zeros((nside, nside), np.uint32)
    gw_rows = _guide_window_rows(l1meta, config, nside)
    if gw_rows is not None:
        mask_dq = mask_dq.copy()
        mask_dq[gw_rows] |= np.uint32(pixel.GW_AFFECTED_DATA)
        mylog.append(
            f"Guide window: flagged {int(gw_rows.sum())} rows "
            "GW_AFFECTED_DATA\n"
        )

    uopt = config.get(
        "RAMP_OPT_PARS", {"slope": 0.4, "gain": 1.8, "sigma_read": 6.5}
    )
    u_ = float(uopt["slope"]) / float(uopt["gain"]) / float(uopt["sigma_read"]) ** 2
    likelihood_fit = bool(config.get("romancal_ramp_fit", False))
    if likelihood_fit:
        # JUMP_KW (reference gen_cal_image.py:428 forwards it to the
        # romancal likelihood fitter): recognized keys map onto the
        # internal fitter's knobs; unrecognized ones are logged and
        # ignored rather than failing the run
        jump_kw = dict(config.get("JUMP_KW") or {})
        rej = float(jump_kw.pop(
            "rejection_threshold", config.get("REJECTION_THRESHOLD", 4.5)
        ))
        plan_kw = {
            k: jump_kw.pop(k)
            for k in ("nu", "u_min", "u_max") if k in jump_kw
        }
        with profiling.span("host.prepare.plan"):
            plan = likely.build_likely_plan(
                meta, exclude_first, rejection_threshold=rej, **plan_kw
            )
        if jump_kw:
            mylog.append(
                "JUMP_KW keys ignored by the internal likelihood "
                f"fitter: {sorted(jump_kw)}\n"
            )
        mylog.append("likelihood (adaptive-weight) ramp fit\n")
        weights_out = plan.W[plan.nu // 2, -1]
    else:
        with profiling.span("host.prepare.plan"):
            plan = ramp.build_plan(
                meta, u_, exclude_first, config.get("JUMP_DETECT_PARS")
            )
        mylog.append(f"\n\nRamp fit optimized for u = {u_:11.5E} s**-1\n")
        mylog.append("weights = {}\n".format(plan.W[-1]))
        weights_out = plan.W[-1]

    # ---- static config ----
    use_amp33 = pack.amp33_valid and "amp33" in l1
    opt_slope = calfiles.amp33_optimal_slope(pack) if use_amp33 else None
    wfi18 = bool(config.get("correct_wfi18_transient", False)) and (
        detector == "WFI18" or detector in pack.wfi18_transient
    )
    if config.get("correct_wfi18_transient", False) and not wfi18:
        mylog.append("Skipping WFI18 transient correction (not WFI18)\n")
    wfi18_taus = tuple(
        pack.wfi18_transient.get(detector, {}).get(
            "taus", WFI18_DEFAULT_TAUS)
    )
    if wfi18:
        mylog.append(
            "WFI18 transient row basis taus = "
            + ", ".join(f"{t:.1f}" for t in wfi18_taus) + " rows\n"
        )
    has_dark_decay = "dark_decay" in caldir
    if has_dark_decay:
        tab = pack.dark_decay[detector]
        dd_signal = _dark_decay_signal(
            read_pattern, frame_time, tab["amplitude"], tab["time_constant"]
        )
        mylog.append("Dark decay correction complete\n")
    else:
        dd_signal = np.zeros(ngrp, dtype=np.float32)

    kernels = resolve_kernels(config, device)
    cfg = dict(
        exclude_first=exclude_first,
        backup=backup,
        use_amp33=bool(use_amp33),
        likelihood_fit=likelihood_fit,
        has_biascorr="biascorr" in caldir,
        has_dark_decay=has_dark_decay,
        wfi18=wfi18,
        first_is_reset=(read_pattern[0] == [0]),
        has_ipc="ipc4d" in caldir,
        ipc=kernels.ipc, lin=kernels.lin, med=kernels.med,
        has_dark_dq=pack.dark_dq is not None,
        skyorder=int(config.get("SKYORDER", -1)),
    )

    # trailing alignment: dark files may carry extra LEADING slices (a
    # reference read the exposure dropped under EXTRACT_REF)
    de = pack.dark_cube.shape[0] - ngrp
    if de < 0:
        raise ValueError(
            f"dark cube has {pack.dark_cube.shape[0]} groups but the "
            f"exposure has {ngrp}"
        )

    # the cal pack's state on the device: looked up, and admitted, whole
    held = _DEVICE_CACHE.pack(pack, device)

    def cal(a, shape=(nside, nside), dtype=torch.float32):  # staged once per device
        if a is None:  # the pack has none
            return torch.zeros(shape, dtype=dtype, device=device)
        return stage(a, device, pack=held)

    def exp(a):  # per-exposure array
        return stage(a, device, cache=False)

    arr = {
        "opt_slope": send(torch.tensor(
            float(np.float32(opt_slope if opt_slope is not None else 0.0)),
            dtype=torch.float32), device),
        "data": exp(data).to(torch.float32),
        "amp33": (exp(l1["amp33"]).to(torch.float32) if "amp33" in l1
                  else cal(None, (ngrp, nside, channelwidth))),
        "amp33_med": cal(pack.amp33_med, (nside, channelwidth)),
        "dark_cube": cal(pack.dark_cube)[de:],
        "dark_slope": cal(pack.dark_slope),
        "dark_dq": cal(pack.dark_dq, dtype=torch.int32),
        "gain": cal(pack.gain),
        "read_sigma": cal(pack.read_sigma),
        # a plane made here (guide window, no mask file) is new each call
        "mask_dq": (cal(mask_dq) if pack.mask_dq is not None and gw_rows is None
                    else exp(mask_dq)),
        "saturation": cal(pack.saturation),
        "saturation_dq": cal(pack.saturation_dq, dtype=torch.int32),
        "biascorr": (cal(pack.biascorr)[pack.biascorr.shape[0] - ngrp:]
                     if pack.biascorr is not None
                     else cal(None, (ngrp, nside - 2 * nb, nside - 2 * nb))),
        "lin_coefs": cal(pack.lin_coefs),
        "lin_smin": cal(pack.lin_smin),
        "lin_smax": cal(pack.lin_smax),
        "lin_sref": cal(pack.lin_sref),
        "lin_dq": cal(pack.lin_dq),
        "flat": cal(pack.flat),
        "area_factor": exp(area_factor),
        "dark_decay_signal": exp(dd_signal),
        "wfi18_basis": exp(_wfi18_row_basis(nside, wfi18_taus)),
    }
    if cfg["has_ipc"]:
        arr["dark_slope_ipc"], arr["flat_ipc"] = ipc_precal(
            pack.flat, pack.dark_slope, pack.gain, pack.ipc_kernel, nb, device, pack=held
        )
        if cfg["ipc"] in SLAB_ROUTES:
            arr["ipc_kernel_padded"] = _pack_planes(
                ("padded", SLAB_TH), pack.ipc_kernel,
                lambda: ipc_slab.kernel_planes_padded(pack.ipc_kernel, th=SLAB_TH),
                device, held)
        else:
            arr["ipc_kernel_frame"] = _pack_planes(
                ("frame", nside, nb), pack.ipc_kernel,
                lambda: ipc_cuda.kernel_planes_frame(pack.ipc_kernel, nside, nb),
                device, held)
    _DEVICE_CACHE.admit(held)

    mylog.append("Saturation check complete\n")
    mylog.append("Linearity correction complete\n")
    mylog.append("Dark current subtracted\n")
    with profiling.span("host.prepare.medgain"):
        medgain = median_gain(pack.gain)
    mylog.append(f"median gain = {medgain:8.5f} e/DN\n")

    return dict(
        arr=arr, plan=plan, cfg=cfg, geom=(nside, nborder, int(channelwidth)),
        meta=meta, read_pattern=read_pattern, frame_time=frame_time,
        uopt=uopt, weights_out=weights_out, medgain=medgain,
        has_dark_decay=has_dark_decay, wfi18=wfi18,
        exclude_first=exclude_first, log=mylog.output, device=device,
        kernels=kernels,
    )


@profiling.span("host.package")
def package_tree(out, prep, l1, config):
    """Package the core's host outputs (:func:`to_host`) into the L2
    ASDF tree: the maps (span ``host.package.maps``), the reference
    pixels (``host.package.refdata``) and the metadata
    (``host.package.meta``)."""
    nside, nborder, _ = prep["geom"]
    nb = nborder
    ngrp = np.asarray(l1["data"]).shape[0]
    l1meta = l1["meta"]
    meta = prep["meta"]
    medgain = prep["medgain"]
    skyorder = prep["cfg"]["skyorder"]
    has_dark_decay = prep["has_dark_decay"]
    wfi18 = prep["wfi18"]
    sliceout = config.get("SLICEOUT", False)
    if sliceout and ngrp >= 128:
        raise ValueError("too many groups")

    slope = out["slope"]
    pdq = out["pdq"]
    ser = out["slope_err_read"]
    sep = out["slope_err_poisson"]

    act = slice(nb, nside - nb)
    with profiling.span("host.package.maps"):
        err = np.hypot(ser, sep).astype(np.float32)
        maps = {
            "data": np.asarray(slope[act, act], np.float32),
            "dq": np.asarray(pdq[act, act], np.uint32),
            "err": err[act, act],
            "var_poisson": np.asarray(sep[act, act] ** 2, np.float32),
            "var_rnoise": np.asarray(ser[act, act] ** 2, np.float32),
            "var_flat": np.zeros((nside - 2 * nb, nside - 2 * nb), np.float16),
            "data_withsky": np.asarray(out["slope_withsky"][act, act], np.float32),
        }
        likely_maps = {}
        if "dumo" in out:
            likely_maps["dumo"] = np.asarray(out["dumo"][act, act], np.float16)
            likely_maps["chisq"] = np.asarray(out["chisq"][act, act], np.float16)
        if sliceout:
            endslice = np.asarray(out["endslice"], np.int8)

    with profiling.span("host.package.meta"):
        # the L2 product carries the WCS of the active-region science frame
        # (0-based CRPIX, as sim_to_l1 writes the sidecar)
        thewcs = wcs_from_config(config)
        wcsinfo = None
        if thewcs is not None:
            w = wcsutils.SIPWCS.from_header(thewcs, zero_based=True)
            wcsinfo = dict(
                w.to_cards(),
                pixel_convention="0-based, active region",
                ra_ref=float(w.crval[0]),
                dec_ref=float(w.crval[1]),
            )

        l2meta = {
            "exposure": dict(l1meta["exposure"]),
            "instrument": dict(l1meta.get("instrument", {})),
            "cal_step": oututils.cal_step_status(
                has_dark_decay, wfi18,
                config.get("correct_wfi18_transient", False),
                has_wcs=wcsinfo is not None,
            ),
            "gain": medgain,
        }
        if wcsinfo is not None:
            l2meta["wcsinfo"] = wcsinfo
            if "pointing" in l1meta:
                l2meta["pointing"] = dict(l1meta["pointing"])
        oututils.add_in_provenance(l2meta)

        processinfo = {
            "medsky": float(out["medsky"]),
            "medgain": medgain,
            "skyorder": skyorder,
            "skycoefs": np.asarray(out["skycoefs"], np.float32),
            "ramp_opt_pars": prep["uopt"],
            "reffiles": _jsonable(config.get("CALDIR", {})),
            "meta": {
                "ngrp": meta["ngrp"],
                "N": meta["N"].astype(np.int16),
                "tbar": meta["tbar"].astype(np.float32),
                "tau": meta["tau"].astype(np.float32),
                "frame_time": prep["frame_time"],
                "read_pattern": prep["read_pattern"],
                "nborder": nborder,
            },
            "weights": prep["weights_out"],
            "config": _jsonable(config),
            "log": prep["log"],
            "exclude_first": prep["exclude_first"],
        }
        if sliceout:
            processinfo["endslice"] = endslice

    im2 = {"meta": l2meta, **maps}
    oututils.add_in_ref_data(im2, l1, pdq, nside, nb)
    im2.update(likely_maps)
    return {"roman": im2, "processinfo": processinfo}


def _jsonable(obj):
    """Deep-copy a config into plain YAML/ASDF-serializable types."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def main(argv=None):
    ap = argparse.ArgumentParser(description="L1 -> L2 calibration of one SCA")
    ap.add_argument("config", help="YAML config (IN, OUT, CALDIR, ...)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    calibrateimage(load_config(args.config), verbose=True, device=args.device)


if __name__ == "__main__":
    main()
