"""Monte-Carlo noise realizations: the ``gen_noise_image`` equivalent, in
PyTorch.

Re-implements the reference's noise engine
(``L1_to_L2/gen_noise_image.py:60-400``): alternative L1 realizations
pushed through the full L1->L2 pipeline and differenced to produce
"noise only" slope images, controlled by the layer mini-DSL
(``'Rz4S2C1'``, ``'O'``, ``'Prb2'``; spec
``docs/L1_to_L2_README.rst:207-239``).  The perturbed cube is handed to
the calibration in memory, never through a temporary file.

Layer commands (capital letter + lower-case/numeric arguments):

- ``R``   : read-noise realization (white + 1/f + amp33); ``a`` = add to
  the science data (default replaces it with the dark cube); ``z<num>``
  = IQR clipping of the difference at ``<num>`` pseudo-sigma.
- ``O``   : Pearson pseudo-Poisson debiasing draws per endslice class.
- ``P``   : re-sampled Poisson noise; ``b<order>`` = sky-only (medfit of
  given order); ``r`` = per-raw-read resampling.
- ``S<order>`` : subtract the medfit sky of the given order.
- ``C...``: comment (ignored).

Engines (``NOISE: BACKEND``): ``device`` (the default) runs the layer
stack on the device from staged tensors (:mod:`.noise_core`) and falls
back to the layer-by-layer engine, on the same device, with a line on
stderr if that fails; ``device-strict`` raises instead; ``host`` runs
the layer-by-layer engine (``calibrate_tree`` re-entry per layer,
``np.percentile`` z-clip), which is also what ``PEARSON_BACKEND: host``
(the numpy Pearson sampler) selects.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; ``PINK_BACKEND``,
``CONTRACT_BACKEND`` and ``SKY_BACKEND`` choose the kernels of the fills,
the 'P...r' resample and the medfits.

Randomness.  Each (layer, component) draws from a ``torch.Generator`` of
its own, seeded by ``numpy.random.SeedSequence(SEED, spawn_key=(0,
layer, component))`` (:func:`layer_stream`; components :data:`R_STREAM`,
:data:`P_STREAM`, :data:`O_STREAM`).  So layers are independent, a
layer's draws do not depend on the layers before it, and a run does not
depend on the runs before it, as with the reference's folded JAX keys
(whose streams torch cannot reproduce: parity is statistical).  Lane
``i`` of a focal-plane runner (``mesh=``, :mod:`.noise_core`) is the
single-SCA runner at :func:`lane_seed` ``(SEED, i)``.
"""

import argparse
import sys

import numpy as np
import torch

from .. import pars
from ..config import layer_subscript, load_config, resolve_device, resolve_kernels
from ..galpoisson import draw_from_pearson
from ..io import asdf_lite, calfiles, fits_lite, staging
from ..ops import contract_cuda, rand, sky
from ..utils import profiling
from . import l1_to_l2, sim_to_l1

#: stream components of one layer
R_STREAM, P_STREAM, O_STREAM = 0, 1, 2
#: first element of a stream's spawn key: the layers, the exposure
#: runner's sim and fill (:mod:`.noise_core`), and the lanes of the
#: focal-plane runners (:func:`lane_seed`)
LAYER_STREAMS, SIM_STREAM, FILL_STREAM, LANE_STREAMS = 0, 1, 2, 3


def stream(seed, key, device):
    """A generator on ``device`` for stream ``key`` (a tuple of ints) of
    ``seed``: its 64-bit seed is the first word of
    ``numpy.random.SeedSequence(seed, spawn_key=key)``."""
    ss = np.random.SeedSequence(int(seed), spawn_key=tuple(int(k) for k in key))
    return rand.sim_generator(int(ss.generate_state(1, np.uint64)[0]), device)


def lane_seed(seed, lane):
    """The seed of lane ``lane`` of a focal-plane run at exposure seed
    ``seed``: the first 64-bit word of ``numpy.random.SeedSequence(seed,
    spawn_key=(LANE_STREAMS, lane))``.  A lane runs exactly the
    single-SCA runner at this seed, so its streams depend on ``seed``
    and ``lane`` only, never on the number of lanes or mesh entries."""
    ss = np.random.SeedSequence(int(seed), spawn_key=(LANE_STREAMS, int(lane)))
    return int(ss.generate_state(1, np.uint64)[0])


def layer_stream(seed, i_layer, component, device):
    """The generator of component ``component`` of layer ``i_layer``."""
    return stream(seed, (LAYER_STREAMS, i_layer, component), device)


def weightvec_table(tbar, weights_last, ngrp, exclude_first):
    """Per-endslice ramp-fit weight vectors (reference
    ``gen_noise_image.py:185-208``): the full-ramp optimal weights for
    the last slice, two-point CDS-style vectors for truncated ramps."""
    start = 1 if exclude_first else 0
    weightvecs = [None] * ngrp
    weightvecs[ngrp - 1] = np.asarray(weights_last, np.float32)
    tbar = np.asarray(tbar, np.float64)
    for iend in range(start + 2, ngrp):
        Kt = np.zeros(ngrp, dtype=np.float32)
        Kt[iend - 1] = 1.0 / (tbar[iend - 1] - tbar[start])
        Kt[start] = -Kt[iend - 1]
        weightvecs[iend - 1] = Kt
    return weightvecs, start


def _weightvecs_and_endslice(processinfo, ngrp):
    """Weight vectors + clipped endslice map from a base-L2 tree."""
    weightvecs, start = weightvec_table(
        processinfo["meta"]["tbar"], processinfo["weights"], ngrp,
        processinfo["exclude_first"],
    )
    endslice = np.asarray(processinfo["endslice"])
    endslice = np.where(endslice > 0, endslice, ngrp - 1)
    return weightvecs, endslice, start


def read_matrix(read_pattern, weightvecs, ngrp):
    """The (ngrp, nreads) float64 read-axis matrix M of 'P...r':
    M[es] = wv[es] @ T, with T[j, r] = |{reads of group j at index >=
    r}| / N_j, so an endslice-es pixel's resampled slope is
    sum_r M[es, r] * inc_r (rows of classes without weights are 0)."""
    nreads = read_pattern[-1][-1] + 1
    T = np.zeros((ngrp, nreads), np.float64)
    for j, grp in enumerate(read_pattern):
        for r in grp:
            T[j, : r + 1] += 1.0 / len(grp)
    M = np.zeros((ngrp, nreads), np.float64)
    for es in range(ngrp):
        if weightvecs[es] is not None:
            M[es] = np.asarray(weightvecs[es], np.float64) @ T
    return M


def resample_increments(incs, e_exp, gain, endslice, read_pattern, weightvecs,
                        ngrp, contract="dot"):
    """The deterministic part of 'P...r' (reference
    ``gen_noise_image.py:268-322``): per-read increments ``incs``
    (nreads, n, n) at rate ``e_exp`` (n, n) contracted into one slope per
    pixel by its endslice class,

        out = (sum_r M[es, r] * inc_r - (sum_r M[es, r]) * e) / gain.

    ``contract``: 'dot' (``torch.einsum``) or 'cuda' (the read
    contraction kernel, :mod:`..ops.contract_cuda`) for the (ngrp,
    nreads) x (nreads, n, n) product; then a select by endslice.  The
    product is the range ``noise.contract``, the select ``noise.resample``
    (:mod:`..utils.profiling`).
    """
    M = read_matrix(read_pattern, weightvecs, ngrp)
    Msum = M.sum(axis=1).astype(np.float32)
    with profiling.span("noise.contract"):
        M_d = torch.from_numpy(M.astype(np.float32)).to(incs.device)
        if contract == "cuda":
            contrib = contract_cuda.contract_reads(M_d, incs)
        else:
            contrib = torch.einsum("er,ryx->eyx", M_d, incs)
    with profiling.span("noise.resample"):
        out = torch.zeros(e_exp.shape, dtype=torch.float32, device=incs.device)
        zero = torch.zeros((), dtype=torch.float32, device=incs.device)
        for es in range(ngrp):
            if weightvecs[es] is not None:
                out = out + torch.where(endslice == es,
                                        (contrib[es] - Msum[es] * e_exp) / gain, zero)
    return out


def resample_traced(gen, e_exp, gain, endslice, read_pattern, weightvecs, ngrp,
                    contract="dot"):
    """'P...r': one Poisson draw of every raw read's increment at rate
    ``e_exp`` (e/frame, (n, n) tensor) from ``gen``, shape (nreads, n,
    n), through :func:`resample_increments`."""
    nreads = read_pattern[-1][-1] + 1
    with profiling.span("noise.resample"):
        incs = rand.poisson(gen, e_exp, shape=(nreads,) + tuple(e_exp.shape))
    return resample_increments(incs, e_exp, gain, endslice, read_pattern,
                               weightvecs, ngrp, contract=contract)


def _load_inputs(config, pack, base_l1, base_l2):
    """The cal pack, base L1 tree and base L2 tree, from the config's
    CALDIR / IN / OUT unless passed; the base L2 must carry SLICEOUT's
    endslice map."""
    if pack is None:
        pack = calfiles.load_caldir_cached(config["CALDIR"])
    if base_l1 is None:
        base_l1 = asdf_lite.open(config["IN"])["roman"]
    if base_l2 is None:
        base_l2 = asdf_lite.open(config["OUT"])
    if "endslice" not in base_l2["processinfo"]:
        raise ValueError(
            "noise generation requires the base L2 run with SLICEOUT=True"
        )
    return pack, base_l1, base_l2


def make_noise_cube(config, seed=None, *, pack=None, base_l1=None,
                    base_l2=None, device=None):
    """Build the (N_layers, nside_active, nside_active) float32 noise
    cube (numpy) on ``device`` (default ``cuda``).

    ``pack`` / ``base_l1`` / ``base_l2`` may be passed in memory; by
    default they load from the config's CALDIR / IN / OUT paths as in
    the reference.  ``NOISE: BACKEND`` chooses the engine (module
    docstring); ``device-strict`` with ``PEARSON_BACKEND: host`` raises.
    """
    device = resolve_device(device)
    nz = config.get("NOISE", {})
    backend = str(nz.get("BACKEND", "device")).lower()
    pearson_host = str(nz.get("PEARSON_BACKEND", "")).lower() == "host"
    if backend == "device-strict" and pearson_host:
        # contradictory: the host Pearson sampler only exists in the
        # layer-by-layer engine, which strict mode forbids falling back to
        raise ValueError(
            "NOISE BACKEND 'device-strict' cannot be combined with "
            "PEARSON_BACKEND 'host' (the host sampler runs only in the "
            "host engine)"
        )
    kw = dict(pack=pack, base_l1=base_l1, base_l2=base_l2, device=device)
    if backend != "host" and not pearson_host:
        try:
            return _make_noise_cube_device(config, seed, **kw)
        except Exception as e:  # noqa: BLE001 -- the key's documented fallback
            if backend == "device-strict":
                raise
            print(f"device noise path failed ({e!r}); "
                  f"falling back to the layer-by-layer engine on {device}",
                  file=sys.stderr)
    return _make_noise_cube_host(config, seed, **kw)


def _make_noise_cube_device(config, seed=None, *, pack=None, base_l1=None,
                            base_l2=None, device=None):
    """The layer stack on the device (:func:`.noise_core.make_staged_noise_runner`)."""
    from . import noise_core  # noise_core imports this module

    seed = int(config["NOISE"]["SEED"] if seed is None else seed)
    pack, base_l1, base_l2 = _load_inputs(config, pack, base_l1, base_l2)
    area_factor = l1_to_l2.area_factor_from_config(config, pack.nside, device=device)
    prep = l1_to_l2.prepare_inputs(base_l1, config, pack, area_factor, device=device)
    run = noise_core.make_staged_noise_runner(
        prep, pack, list(config["NOISE"]["LAYER"]), config)
    cube, _base, _checksum = run(seed, prep["arr"])
    return noise_core.cube_to_host(cube)


def _make_noise_cube_host(config, seed=None, *, pack=None, base_l1=None,
                          base_l2=None, device=None):
    """Layer-by-layer engine (reference semantics): per layer, the
    perturbed L1 tree goes through ``calibrate_tree`` on ``device``; the
    difference, clip, Pearson draw and resample run per layer."""
    from . import noise_core  # noise_core imports this module

    seed = int(config["NOISE"]["SEED"] if seed is None else seed)
    rng = np.random.default_rng(seed)
    pack, base_l1, base_l2 = _load_inputs(config, pack, base_l1, base_l2)
    nside = pack.nside
    nb = pars.nborder
    na = nside - 2 * nb
    act = slice(nb, nside - nb)
    area_factor = l1_to_l2.area_factor_from_config(config, nside, device=device)
    kernels = resolve_kernels(config, device)

    layers = config["NOISE"]["LAYER"]
    noiseimage = np.zeros((len(layers), na, na), dtype=np.float32)

    read_pattern = [list(g) for g in base_l1["meta"]["exposure"]["read_pattern"]]
    ngrp = len(read_pattern)
    frame_time = float(base_l1["meta"]["exposure"].get("frame_time", pars.read_time))
    nvec = torch.tensor([len(g) for g in read_pattern], dtype=torch.float32,
                        device=device)
    cw = (np.asarray(base_l1["amp33"]).shape[-1] if "amp33" in base_l1
          else max(nside // 32, 4))
    gain = np.clip(pack.gain, 1e-4, 1e4)
    gain_a = gain[act, act]
    withsky = np.asarray(base_l2["roman"]["data_withsky"])

    dark_ref = None  # (dark_u16, calibrated slope), loop-invariant

    for i_noise, cmd in enumerate(layers):
        # shallow copy: layers only REASSIGN top-level keys (data, amp33)
        mytree = dict(base_l1)
        diff = np.zeros((na, na), dtype=np.float32)

        if "R" in cmd:
            flags = layer_subscript(cmd, "R")
            if "a" not in flags:
                # the dark cube through the pipeline: no randomness, and
                # the exposure's amp33 is the same in every layer, so
                # once per call
                if dark_ref is None:
                    de = pack.dark_cube.shape[0] - ngrp
                    if de not in (0, 1):
                        raise ValueError("Dark data cube has the wrong shape.")
                    dark_u16 = np.clip(pack.dark_cube[de:], 0, 65535).astype(np.uint16)
                    ref_tree, _ = l1_to_l2.calibrate_tree(
                        dict(mytree, data=dark_u16), config, pack, area_factor,
                        device=device)
                    dark_ref = (dark_u16, np.asarray(ref_tree["roman"]["data"]))
                mytree["data"], orig_data = dark_ref
            else:
                orig_data = np.asarray(base_l2["roman"]["data"])

            # white read noise on the active region, then a full
            # reference-pixel / 1-f / amp33 refill
            gen = layer_stream(seed, i_noise, R_STREAM, device)
            src = staging.place(mytree["data"], device)[:, act, act].to(torch.float32)
            white = (rand.normal(gen, (ngrp, na, na))
                     * staging.stage(pack.read_sigma, device)[act, act]
                     / torch.sqrt(nvec)[:, None, None])
            im_act = torch.clamp(torch.round(src + white), 0, 65535)
            im, amp33 = sim_to_l1.fill_in_refdata_and_1f(
                gen, im_act, pack, read_pattern, nside, int(cw),
                fill_in_banding=True,
                amp33=(np.zeros(1) if ("amp33" in mytree and pack.amp33_valid)
                       else None),
                nborder=nb, pink_backend=kernels.pink,
            )
            mytree["data"] = staging.u16_to_host(im)
            if amp33 is not None:
                mytree["amp33"] = staging.u16_to_host(amp33)
            del im, amp33, im_act, white, src

            new_tree, _ = l1_to_l2.calibrate_tree(mytree, config, pack,
                                                  area_factor, device=device)
            diff = (np.asarray(new_tree["roman"]["data"]) - orig_data).astype(np.float32)

            if "z" in flags:
                zclip = float(layer_subscript(flags.upper(), "Z"))
                iqr = np.percentile(diff, 75) - np.percentile(diff, 25)
                med = np.percentile(diff, 50)
                diff = np.clip(diff, med - zclip * iqr / 1.34896,
                               med + zclip * iqr / 1.34896)

        if "O" in cmd:
            gI = gain_a * withsky
            weightvecs, endslice, start = _weightvecs_and_endslice(
                base_l2["processinfo"], ngrp)
            tilnus = noise_core._tilnus_table(read_pattern, weightvecs, start,
                                              frame_time)
            backend = str(config.get("NOISE", {}).get("PEARSON_BACKEND", "")).lower()
            if backend == "host":
                noise_array = np.zeros((na, na), dtype=np.float32)
                for i, (t21, t31, t41) in tilnus.items():
                    pix = np.where(endslice == i)
                    if len(pix[0]) == 0:
                        continue
                    noise_array[pix] = draw_from_pearson(t21, t31, t41, gI[pix],
                                                         rng=rng)
                diff += noise_array / gain_a
            else:
                diff += noise_core._pearson_o_draw(
                    layer_stream(seed, i_noise, O_STREAM, device),
                    staging.place(endslice, device).to(torch.int32),
                    staging.place(gI, device), staging.place(gain_a, device), tilnus, na,
                ).cpu().numpy()

        if "P" in cmd:
            flags = layer_subscript(cmd, "P")
            if "b" in flags:
                sky_order = int("0" + layer_subscript(flags.upper(), "B"))
                _, skylevel = sky.medfit(staging.place(withsky, device), order=sky_order,
                                         backend=kernels.med)
            else:
                skylevel = staging.place(withsky, device)
            if "r" in flags:
                weightvecs, endslice, _ = _weightvecs_and_endslice(
                    base_l2["processinfo"], ngrp)
                e_per_slice = torch.clamp(
                    skylevel * staging.place(gain_a, device) * frame_time, min=0.0)
                diff += resample_traced(
                    layer_stream(seed, i_noise, P_STREAM, device), e_per_slice,
                    staging.place(gain_a, device), staging.place(endslice, device).to(torch.int32),
                    read_pattern, weightvecs, ngrp, contract=kernels.contract,
                ).cpu().numpy()

        if "S" in cmd:
            sky_order = int("0" + layer_subscript(cmd, "S"))
            _, model = sky.medfit(staging.place(diff, device), order=sky_order,
                                  backend=kernels.med)
            diff = diff - model.cpu().numpy()

        noiseimage[i_noise] = diff

    return noiseimage


def generate_all_noise(config, device=None):
    """Build the noise cube and write the output ASDF (and
    optional FITS).  Reference: ``gen_noise_image.generate_all_noise:334``.
    """
    noiseimage = make_noise_cube(config, device=device)

    if "NOISE_PRECISION" in config:
        if config["NOISE_PRECISION"] == 16:
            noiseimage = noiseimage.astype(np.float16)
        if config["NOISE_PRECISION"] not in (16, 32):
            raise ValueError("Unsupported noise precision.")

    tree = {"config": l1_to_l2._jsonable(config), "noise": noiseimage}
    asdf_lite.AsdfFile(tree).write_to(config["NOISE"]["OUT"])
    if config.get("FITSOUT", False):
        fits_lite.PrimaryHDU(noiseimage.astype(np.float32)).writeto(
            config["NOISE"]["OUT"][:-5] + "_asdf_to.fits", overwrite=True
        )


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="L1 -> L2 of one SCA (with SLICEOUT), then its noise cube")
    ap.add_argument("config", help="YAML config (IN, OUT, CALDIR, NOISE, ...)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    config = load_config(args.config)
    l1_to_l2.calibrateimage(config | {"SLICEOUT": True}, device=args.device)
    generate_all_noise(config, device=args.device)


if __name__ == "__main__":
    main()
