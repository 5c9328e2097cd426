"""The noise engine on the device: staged runners over tensors.

A full noise stack of one exposure (base L1->L2 calibration plus every
noise layer: 'R' re-entries of the calibration core, Pearson 'O' draws,
per-raw-read Poisson 'P' resampling, 'S' sky removal) runs from staged
tensors without the cube leaving the device; only the final (nlayers,
na, na) cube is read back.  Statistical content of every layer matches
the layer-by-layer engine of :mod:`.noise` and the JAX package's
(``tests/test_torch_noise.py``).

The runners, each returning ``run(seed, arrs) -> (cube, base, checksum)``:

- :func:`make_staged_noise_runner`: an existing L1 exposure
  (``arrs = prep["arr"]``, the ``generate_all_noise`` path);
- :func:`make_staged_exposure_runner`: sim -> L1 (``make_l1_fullcal``,
  ``fill_in_refdata_and_1f``) -> base core -> layers, from a rate map
  (:func:`exposure_arrays`).

With ``mesh=`` (:func:`..parallel.sca_mesh`) each runner is the
focal-plane form: ``run(seed, batch)`` takes one exposure seed and a
batch with a leading SCA axis (:func:`..parallel.broadcast_batch`,
:func:`..parallel.shard_batch`); lane ``i`` runs on mesh entry ``i %
len(mesh)`` as the single-SCA runner at ``noise.lane_seed(seed, i)``,
so it equals that runner bit for bit and its streams do not depend on
the number of lanes or entries.  (The JAX package derives lane keys by
splitting one key, because its vmapped draws read lane 0's key only;
here each lane is a run of its own.)  The outputs come stacked on the
first entry's device: ``(cube (n_sca, nlayers, na, na), base, checksums
(n_sca,))``.

:func:`make_exposure_noise_core` and :func:`make_full_exposure_core`
are the same runners giving ``(cube, base)``: the JAX package compiles
those as single programs, which torch has no need for.  Random streams:
:func:`.noise.stream` (each layer and component its own generator; the
exposure's sim and fill theirs).
"""

import numpy as np
import torch

from ..config import layer_subscript, resolve_kernels
from ..galpoisson import draw_from_pearson_torch, get_tilde_nus
from ..io import staging
from ..ops import rand, sky
from ..utils import profiling
from . import l1_to_l2, noise, sim_to_l1
from .noise import O_STREAM, P_STREAM, R_STREAM, layer_stream

#: prefix of the layers' device ranges (:class:`..utils.profiling.span`,
#: one flag read each when no profiler records), none inside another or
#: around a core's or a fill's range: ``noise.perturb`` (the white read
#: noise of an 'R' re-entry, and its dark source), ``noise.diff`` (an
#: 'R' difference and z-clip), ``noise.pearson`` ('O'), ``noise.resample``
#: and ``noise.contract`` ('P...r', :func:`.noise.resample_increments`),
#: ``noise.medfit`` ('b' and 'S' medfits, with the subtraction),
#: ``noise.stack``.  The host containers around them: ``host.lane`` (one
#: call of an exposure runner), ``host.noise.base`` (the base core) and
#: ``host.noise.layer<i>`` (layer i; the first layer that needs the dark
#: reference computes it); ``host.noise.to_host`` (:func:`cube_to_host`).
PREFIX = "noise"


def _tilnus_table(read_pattern, weightvecs, start, frame_time):
    """Per-endslice (t21, t31, t41) scaled tilde-nus (static floats),
    shared by the device runners and the layer-by-layer engine."""
    a_beta = np.array([g[0] for g in read_pattern])
    N_beta = np.array([len(g) for g in read_pattern])
    tilnus = {}
    for i in range(start + 1, len(read_pattern)):
        if weightvecs[i] is None:
            continue
        t21, t31, t41, _ = get_tilde_nus(N_beta, a_beta, weightvecs[i])
        tilnus[i] = (
            float(t21 * frame_time),
            float(t31 * frame_time**2),
            float(t41 * frame_time**3),
        )
    return tilnus


def _pearson_o_draw(gen, endslice_c, gI, gain_a, tilnus, na):
    """'O'-layer Pearson pseudo-Poisson debias draw, in DN/s: per-pixel
    tilde-nu maps by endslice class, one :func:`draw_from_pearson_torch`
    call for every class."""
    dev = gI.device
    t21m = torch.ones((na, na), dtype=torch.float32, device=dev)
    t31m = torch.zeros((na, na), dtype=torch.float32, device=dev)
    # truly inadmissible filler (beta2 < 0 for every physical gI) so
    # no-weight lanes never classify as a live Pearson type: a mild -1
    # lands in the type-1 region for gI > 0.5 and only the trailing
    # * hasw multiply would hide the spurious draws (a NaN there would
    # leak through the mask)
    t41m = torch.full((na, na), -1.0e12, dtype=torch.float32, device=dev)
    hasw = torch.zeros((na, na), dtype=torch.bool, device=dev)
    for i, (t21, t31, t41) in tilnus.items():
        sel = endslice_c == i
        t21m = torch.where(sel, t21, t21m)
        t31m = torch.where(sel, t31, t31m)
        t41m = torch.where(sel, t41, t41m)
        hasw = hasw | sel
    draw = draw_from_pearson_torch(gen, t21m, t31m, t41m, gI)
    return draw * hasw / gain_a


def _p_layer_draw(gen, endslice_c, withsky_act, gain_a, *, read_pattern,
                  weightvecs, ngrp, frame_time, med, contract, sky_order=None,
                  resample=False, final_sky_order=None):
    """'P'-layer resampled-Poisson diff.

    ``sky_order``: the 'b' flag's medfit order for the sky level;
    ``resample``: the 'r' flag; ``final_sky_order``: a trailing 'S'.
    ``med``: the medfit's backend ('cuda': the block-median kernel).
    """
    if sky_order is not None:
        with profiling.span(f"{PREFIX}.medfit"):
            _, skylevel = sky.medfit(withsky_act, order=sky_order, backend=med)
    else:
        skylevel = withsky_act
    if not resample:
        diff = torch.zeros(withsky_act.shape, dtype=torch.float32,
                           device=withsky_act.device)
    else:
        with profiling.span(f"{PREFIX}.resample"):
            e_exp = torch.clamp(skylevel * gain_a * frame_time, min=0.0)
        diff = noise.resample_traced(gen, e_exp, gain_a, endslice_c, read_pattern,
                                     weightvecs, ngrp, contract=contract)
    if final_sky_order is not None:
        diff = _subtract_medfit(diff, final_sky_order, med)
    return diff


def _subtract_medfit(diff, order, med):
    """``diff`` less its medfit sky of ``order`` (an 'S')."""
    with profiling.span(f"{PREFIX}.medfit"):
        _, model = sky.medfit(diff, order=order, backend=med)
        return diff - model


@profiling.span("host.noise.to_host")
def cube_to_host(cube):
    """The (nlayers, na, na) noise cube as host numpy, counted as
    ``d2h_bytes`` (:func:`..io.staging.fetch`): how
    :func:`.noise.make_noise_cube` hands it on."""
    return staging.fetch(cube)


def exposure_arrays(prep, rate):
    """Array bundle of :func:`make_staged_exposure_runner`: the L1->L2
    bundle of :func:`..l1_to_l2.prepare_inputs` (built against any L1 tree
    of the target geometry and MA table) without its ``data``, which the
    synthesized L1 replaces, and ``rate``, the (na, na) active-region
    charge rate in e/s, staged on the prep's device.  The sim reads the
    rest of the cal pack from ``pack`` (staged once per device)."""
    arr = {k: v for k, v in prep["arr"].items() if k != "data"}
    arr["rate"] = staging.stage(np.asarray(rate, np.float32), prep["device"], cache=False)
    return arr


class _Stages:
    """The layer bodies of one (prep, cal pack): two restricted-output
    calibration cores and the per-layer stages on tensors.  The sim, the
    fills and the layers take their kernels (:class:`..config.Kernels`)
    from ``config`` where one is passed, else from ``prep["kernels"]``;
    the cores theirs from ``prep["cfg"]``."""

    def __init__(self, prep, pack, config=None):
        cfg = prep["cfg"]
        self.cfg, self.pack = cfg, pack
        self.kernels = resolve_kernels(config, prep["device"]) if config else prep["kernels"]
        self.geom = nside, nb, cw = prep["geom"]
        self.na = nside - 2 * nb
        self.act = slice(nb, nside - nb)
        self.read_pattern = prep["read_pattern"]
        self.frame_time = float(prep["frame_time"])
        self.ngrp = len(self.read_pattern)
        self.do_amp33 = bool(cfg["use_amp33"])
        plan, geom = prep["plan"], prep["geom"]
        # the 'R' re-entries consume only the slope; the base feeding the
        # layers needs these four
        self.core_r = l1_to_l2.make_core(plan, dict(cfg, outputs=("slope",)), geom)
        self.core_base = l1_to_l2.make_core(
            plan, dict(cfg, outputs=("slope", "slope_withsky", "endslice", "pdq")),
            geom)
        self.weightvecs, start = noise.weightvec_table(
            prep["meta"]["tbar"], prep["weights_out"], self.ngrp,
            cfg["exclude_first"])
        self.tilnus = _tilnus_table(self.read_pattern, self.weightvecs, start,
                                    self.frame_time)

    def simulate(self, seed, arrs):
        """sim -> L1 -> fill of one exposure from ``arrs["rate"]``
        (:func:`exposure_arrays`): the sim draws from stream
        ``(SIM_STREAM,)`` of ``seed``, the fill from ``(FILL_STREAM,)``.
        Returns ``arrs`` with the exposure's ``data`` (and ``amp33``)."""
        dev = arrs["rate"].device
        res, _l1dq = sim_to_l1.make_l1_fullcal(
            noise.stream(seed, (noise.SIM_STREAM,), dev), arrs["rate"],
            self.read_pattern, self.pack, frame_time=self.frame_time, crparam={},
            ipc_backend=self.kernels.ipc_fwd, contract=self.kernels.contract,
            lin_backend=self.kernels.lin)
        data, amp33 = self.fill(noise.stream(seed, (noise.FILL_STREAM,), dev), res)
        del res
        arrs0 = dict(arrs, data=data)
        if amp33 is not None:
            arrs0["amp33"] = amp33
        return arrs0

    def fill(self, gen, im_act):
        """Reference-pixel / 1-f / amp33 fill around the (ngrp, na, na)
        active cube: (data, amp33 or None), float32 frames of the
        uint16 range, as the core reads them."""
        nside, nb, cw = self.geom
        im, amp33 = sim_to_l1.fill_in_refdata_and_1f(
            gen, im_act, self.pack, self.read_pattern, nside, cw,
            fill_in_banding=True, amp33=np.zeros(1) if self.do_amp33 else None,
            nborder=nb, pink_backend=self.kernels.pink)
        return im.to(torch.float32), (None if amp33 is None else amp33.to(torch.float32))

    def perturb_fill(self, gen, src, arrs):
        """White read noise on the active region of ``src`` (a (ngrp,
        nside, nside) cube of the uint16 range) and a full refill.  The
        white normals are float32, as the port's sim draws them."""
        act = self.act
        with profiling.span(f"{PREFIX}.perturb"):
            nvec = torch.tensor([len(g) for g in self.read_pattern],
                                dtype=torch.float32, device=src.device)
            white = (rand.normal(gen, (self.ngrp, self.na, self.na))
                     * arrs["read_sigma"][act, act] / torch.sqrt(nvec)[:, None, None])
            im_act = torch.clamp(torch.round(src[:, act, act] + white), 0, 65535)
        return self.fill(gen, im_act)

    def r_cal_diff(self, arrs, orig_slope, zclip=None, sky_order=None):
        """'R'-layer re-calibration and difference (reference
        ``gen_noise_image.py:98-170``): slope-only core, difference on the
        active region, IQR z-clip (:func:`..ops.sky.bisect_quantiles`),
        and a trailing 'S' of a pure-'R' layer."""
        act = self.act
        slope = self.core_r(arrs)["slope"]
        with profiling.span(f"{PREFIX}.diff"):
            diff = slope[act, act] - orig_slope[act, act]
            if zclip is not None:
                q25, med, q75 = sky.bisect_quantiles(diff, (0.25, 0.5, 0.75))
                half = zclip * (q75 - q25) / 1.34896
                diff = torch.clamp(diff, med - half, med + half)
        if sky_order is not None:
            diff = self.s_layer(diff, sky_order)
        return diff

    def _endslice_gain(self, endslice, gain):
        es = endslice.to(torch.int32)
        es = torch.where(es > 0, es, self.ngrp - 1)
        return es, torch.clamp(gain, 1e-4, 1e4)[self.act, self.act]

    def o_layer(self, gen, endslice, withsky, gain):
        with profiling.span(f"{PREFIX}.pearson"):
            es, gain_a = self._endslice_gain(endslice, gain)
            gI = gain_a * withsky[self.act, self.act]
            return _pearson_o_draw(gen, es, gI, gain_a, self.tilnus, self.na)

    def p_layer(self, gen, endslice, withsky, gain, sky_order=None,
                resample=False, final_sky_order=None):
        with profiling.span(f"{PREFIX}.resample"):
            es, gain_a = self._endslice_gain(endslice, gain)
        return _p_layer_draw(
            gen, es, withsky[self.act, self.act], gain_a,
            read_pattern=self.read_pattern, weightvecs=self.weightvecs,
            ngrp=self.ngrp, frame_time=self.frame_time, med=self.kernels.med,
            contract=self.kernels.contract, sky_order=sky_order,
            resample=resample, final_sky_order=final_sky_order)

    def s_layer(self, diff, sky_order):
        return _subtract_medfit(diff, sky_order, self.kernels.med)


def _run_layers(st, layers, seed, arrs0, base, data):
    """The per-layer loop of the runners.

    ``seed``: each layer and component draws from
    :func:`.noise.layer_stream`; ``arrs0``: the staged bundle whose
    ``data`` and ``amp33`` are the exposure's; ``data``: the exposure's
    cube (the source of 'Ra' adds).  The dark reference ('R' without
    'a': the dark cube through the core) reads the exposure's amp33 in
    its refpix step, so it is computed once per call, never reused
    across calls.  Returns the list of (na, na) diffs.
    """
    dev = data.device
    dark = None
    diffs = []
    for i_noise, cmd in enumerate(layers):
        with profiling.span(f"host.{PREFIX}.layer{i_noise}"):
            comps = [c for c in "ROP" if c in cmd]
            s_ord = int("0" + layer_subscript(cmd, "S")) if "S" in cmd else None
            # a single-component 'R' or 'P' layer applies its trailing 'S'
            # inside that component; others to the summed diff
            fuse_s = s_ord if comps in (["R"], ["P"]) else None
            diff = None
            if "R" in cmd:
                flags = layer_subscript(cmd, "R")
                if "a" not in flags:
                    if dark is None:
                        # uint16-quantized (truncated) as the reference writes it
                        with profiling.span(f"{PREFIX}.perturb"):
                            data_ref = torch.clamp(arrs0["dark_cube"], 0, 65535).to(
                                torch.int32).to(torch.float32)
                        dark = (data_ref, st.core_r(dict(arrs0, data=data_ref))["slope"])
                    src, orig = dark
                else:
                    src, orig = data, base["slope"]
                new_data, new_a33 = st.perturb_fill(
                    layer_stream(seed, i_noise, R_STREAM, dev), src, arrs0)
                arrs_r = dict(arrs0, data=new_data)
                if new_a33 is not None:
                    arrs_r["amp33"] = new_a33
                zc = float(layer_subscript(flags.upper(), "Z")) if "z" in flags else None
                diff = st.r_cal_diff(arrs_r, orig, zclip=zc, sky_order=fuse_s)
                del arrs_r, new_data, new_a33
            if "O" in cmd:
                d = st.o_layer(layer_stream(seed, i_noise, O_STREAM, dev),
                               base["endslice"], base["slope_withsky"], arrs0["gain"])
                diff = d if diff is None else diff + d
            if "P" in cmd:
                flags = layer_subscript(cmd, "P")
                so = int("0" + layer_subscript(flags.upper(), "B")) if "b" in flags else None
                d = st.p_layer(layer_stream(seed, i_noise, P_STREAM, dev),
                               base["endslice"], base["slope_withsky"], arrs0["gain"],
                               sky_order=so, resample="r" in flags,
                               final_sky_order=fuse_s)
                diff = d if diff is None else diff + d
            if diff is None:
                diff = torch.zeros((st.na, st.na), dtype=torch.float32, device=dev)
            if s_ord is not None and fuse_s is None:
                diff = st.s_layer(diff, s_ord)
            diffs.append(diff)
    return diffs


def _finish(diffs, base):
    with profiling.span(f"{PREFIX}.stack"):
        cube = torch.stack(diffs)
        return cube, base, cube.sum()


def mesh_runner(run1, mesh):
    """The focal-plane form of a single-SCA runner ``run1(seed, arrs)``:
    ``run(seed, batch)`` runs lane ``i`` as ``run1(noise.lane_seed(seed,
    i), lane_i)`` on mesh entry ``i % len(mesh)``, the outputs stacked
    on the first entry's device (module docstring).  ``run.timings``:
    the last call's per-entry and per-lane wall times
    (:func:`..parallel.run_lanes`)."""
    from .. import parallel

    def run(seed, batch):
        lanes = parallel.lanes_of(mesh, batch)
        return parallel.run_stacked(
            mesh, lambda i, lane: run1(noise.lane_seed(seed, i), lane), lanes,
            timings=run.timings)

    run.timings = []
    return run


def make_staged_noise_runner(prep, pack, layers, config=None, mesh=None):
    """Device-resident noise stack for an EXISTING L1 exposure (the
    config-driven ``generate_all_noise`` path).

    ``prep``: :func:`..l1_to_l2.prepare_inputs` of the base L1 tree;
    ``layers``: the NOISE LAYER command list; ``config``: a run config
    whose kernel choice the sim, fills and layers take in place of the
    prep's.  Returns ``run(seed,
    arrs) -> (noise_cube (nlayers, na, na), base_out, checksum)`` on the
    prep's device, ``arrs`` being ``prep["arr"]`` (``data`` = the base L1
    cube); ``checksum`` is the cube's sum.  ``mesh``: the focal-plane
    form (module docstring), over a batch of such bundles.
    """
    st = _Stages(prep, pack, config)

    def run(seed, arrs):
        with profiling.span(f"host.{PREFIX}.base"):
            base = st.core_base(arrs)
        return _finish(_run_layers(st, layers, seed, arrs, base, arrs["data"]), base)

    return run if mesh is None else mesh_runner(run, mesh)


def make_staged_exposure_runner(prep, pack, layers, config=None, mesh=None):
    """Full exposure on the device: rate map -> L1 synthesis
    (:func:`..sim_to_l1.make_l1_fullcal`: Poisson/CR accumulation, IL
    forward model, read noise) -> reference-pixel / 1-f / amp33 fill ->
    base calibration -> every noise layer (the reference's per-exposure
    production workload, ``OpenUniverse_to_L1L2.py:155-169``: sim ->
    calibrate -> noise).

    Returns ``run(seed, arrs) -> (noise_cube, base_out, checksum)``;
    ``arrs`` is :func:`exposure_arrays`.  The sim draws from stream
    ``(SIM_STREAM,)`` of ``seed``, the fill from ``(FILL_STREAM,)``, the
    layers as in :func:`make_staged_noise_runner`.  ``mesh``: the
    focal-plane form (module docstring), over a batch of such bundles.
    """
    st = _Stages(prep, pack, config)

    def run(seed, arrs):
        with profiling.span("host.lane"):
            arrs0 = st.simulate(seed, arrs)
            with profiling.span(f"host.{PREFIX}.base"):
                base = st.core_base(arrs0)
            return _finish(_run_layers(st, layers, seed, arrs0, base, arrs0["data"]),
                           base)

    return run if mesh is None else mesh_runner(run, mesh)


def make_exposure_noise_core(prep, pack, layers, config=None):
    """:func:`make_staged_noise_runner`, giving ``(cube, base)``."""
    run = make_staged_noise_runner(prep, pack, layers, config)
    return lambda seed, arrs: run(seed, arrs)[:2]


def make_full_exposure_core(prep, pack, layers, config=None):
    """:func:`make_staged_exposure_runner`, giving ``(cube, base)``."""
    run = make_staged_exposure_runner(prep, pack, layers, config)
    return lambda seed, arrs: run(seed, arrs)[:2]
