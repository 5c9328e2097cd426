"""Monte-Carlo validation: many sim -> L1 -> L2 realizations of one scene.

Equivalent of the reference's ``validation_tests/many_realizations.py``:
re-runs the full chain N times with spaced seeds and reports an 8-slice
statistics cube (ideal slope, median L1 group difference, median L2,
unmasked count / mean / std, bias against the truth, median reported
error).  Each realization stays in memory (``calibrate_tree``); the
masked moments accumulate as it goes, with no memmap staging.

:func:`run_many` goes through the files; :func:`run_many_mesh` runs the
realizations as lanes of the staged sim -> fill -> calibration chain
over a mesh of devices, without files.

Usage::

    python -m romanimpreprocess_tpu_torch.validation.many_realizations \\
        config1.yaml config2.yaml N [outfile.fits] [--mesh] [--device=cpu]
"""

import sys

import numpy as np
import torch

from .. import pars, parallel
from ..config import load_config, resolve_device
from ..io import asdf_lite, calfiles, fits_lite
from ..ops.mask import PixelMask1
from ..pipeline import l1_to_l2, noise, noise_core, sim_to_l1


def _ideal_slope(config1, nside, act):
    """Ideal slope (DN/s) in the science frame, from the truth FITS."""
    hdus = fits_lite.open_fits(config1["IN"])
    truth = hdus[0].data / float(hdus[0].header["EXPTIME"]) / pars.g_ideal
    scanum = int(config1["IN"].split("_")[-1].split(".")[0])
    truth = truth[:, ::-1] if scanum % 3 == 0 else truth[::-1, :]
    slope_ideal = np.zeros((nside, nside), np.float32)
    slope_ideal[act, act] = truth
    return slope_ideal


def _stats_stack(slope_ideal, diffs, images, errs, count, s1, s2, nside, act):
    """The 8-slice statistics cube from the per-realization stacks and
    the running masked moments (shared by both drivers)."""
    mean = s1 / np.maximum(count, 1e-25)
    std = np.sqrt(np.clip(s2 / np.maximum(count, 1e-25) - mean**2, 0, None))
    mean = np.where(count > 0.1, mean, -1000.0)
    std = np.where(count > 0.1, std, -1000.0)

    def embed(a):
        out = np.zeros((nside, nside), np.float32)
        out[act, act] = a
        return out

    return np.stack(
        [
            slope_ideal,
            # full frame: the reference's diffs keep the 4-pixel
            # reference border, whose ramp this slice diagnoses
            np.median(diffs, axis=0),
            embed(np.median(images, axis=0)),
            embed(count),
            embed(mean),
            embed(std),
            embed(mean - slope_ideal[act, act]),
            embed(np.median(errs, axis=0)),
        ]
    )


class _Accumulator:
    """Per-realization stacks and masked moments."""

    def __init__(self, nrun, nside, na):
        self.diffs = np.zeros((nrun, nside, nside), np.float32)
        self.images = np.zeros((nrun, na, na), np.float32)
        self.errs = np.zeros((nrun, na, na), np.float32)
        self.count = np.zeros((na, na), np.float32)
        self.s1 = np.zeros((na, na), np.float32)
        self.s2 = np.zeros((na, na), np.float32)

    def add(self, j, diff, image, err, masked):
        self.diffs[j], self.images[j], self.errs[j] = diff, image, err
        w = ~masked
        self.count += w
        self.s1 += np.where(w, self.images[j], 0.0)
        self.s2 += np.where(w, self.images[j] ** 2, 0.0)

    def stack(self, slope_ideal, nside, act):
        return _stats_stack(slope_ideal, self.diffs, self.images, self.errs, self.count,
                            self.s1, self.s2, nside, act)


def _check_pipe(config1, config2):
    if config1["OUT"] != config2["IN"]:
        raise ValueError("broken pipe: config1[OUT] != config2[IN]")


def run_many(config1, config2, nrun, outfile=None, seed_step=10, device=None):
    """Run ``nrun`` realizations through the files on ``device``
    (default ``cuda``); returns the (8, nside, nside) stack."""
    device = resolve_device(device)
    config1 = dict(config1)
    config1.setdefault("SEED", 100)
    _check_pipe(config1, config2)

    pack = calfiles.load_caldir(config2["CALDIR"])
    nside = pack.nside
    nb = pars.nborder
    act = slice(nb, nside - nb)
    area_factor = None  # from the sidecar the first sim writes
    slope_ideal = _ideal_slope(config1, nside, act)
    acc = _Accumulator(nrun, nside, nside - 2 * nb)

    for j in range(nrun):
        config1 = dict(config1, SEED=config1["SEED"] + seed_step)
        sim_to_l1.run_config(config1, device=device)
        l1 = asdf_lite.open(config2["IN"])["roman"]
        if area_factor is None:
            area_factor = l1_to_l2.area_factor_from_config(config2, nside, device=device)
        tree, _ = l1_to_l2.calibrate_tree(l1, config2, pack, area_factor, device=device)
        r = tree["roman"]
        l1d = np.asarray(l1["data"], np.float32)
        acc.add(j, l1d[-1] - l1d[1], np.asarray(r["data"]), np.asarray(r["err"]),
                PixelMask1.build(r["dq"]).numpy())

    stack = acc.stack(slope_ideal, nside, act)
    if outfile:
        fits_lite.PrimaryHDU(stack).writeto(outfile, overwrite=True)
    return stack


#: the core outputs a realization needs
_OUTPUTS = ("slope", "slope_err_read", "slope_err_poisson", "pdq")


def run_many_mesh(config1, config2, nrun, outfile=None, mesh=None, seed=None):
    """``nrun`` realizations as lanes over ``mesh`` (default
    :func:`..parallel.sca_mesh`): the batch axis is realizations.

    One realization goes through the files first (it writes the L1 and
    the WCS sidecar that fix the prep, the pixel area and the truth
    rate); the statistics come from the lanes only: batch ``b`` of
    ``len(mesh)`` realizations runs lane ``j`` as the staged sim -> fill
    -> calibration chain (``noise_core``'s exposure runner without its
    layers) at ``noise.lane_seed(seed0 + b, j)``.  So the result
    measures the chain of :func:`run_many` from other streams.  Returns
    the same (8, nside, nside) stack.
    """
    config1 = dict(config1)
    config1.setdefault("SEED", 100)
    _check_pipe(config1, config2)
    if "EXTRACT_REF" in config1:
        # run_config simulates the full read pattern and subtracts the
        # offset-shifted reference read from every group; the staged
        # chain synthesizes the post-extraction pattern directly and
        # would measure a chain without that correlated noise
        raise ValueError(
            "run_many_mesh does not model EXTRACT_REF reference-read "
            "subtraction; use run_many for EXTRACT_REF configs"
        )
    if str(config1.get("CALDIR")) != str(config2.get("CALDIR")):
        # the staged chain sims and calibrates from config2's pack: a
        # mismatched-calibration study would silently lose its mismatch
        raise ValueError(
            "run_many_mesh requires config1[CALDIR] == config2[CALDIR] "
            "(the staged core sims and calibrates from one pack); use "
            "run_many for mismatched-calibration validations"
        )
    mesh = parallel.sca_mesh() if mesh is None else tuple(resolve_device(d) for d in mesh)
    dev0 = mesh[0]

    x = sim_to_l1.run_config(config1, device=dev0)  # L1 + sidecar + truth rate
    pack = calfiles.load_caldir_cached(config2["CALDIR"])
    nside = pack.nside
    nb = pars.nborder
    act = slice(nb, nside - nb)
    slope_ideal = _ideal_slope(config1, nside, act)
    area_factor = l1_to_l2.area_factor_from_config(config2, nside, device=dev0)
    l1 = asdf_lite.open(config2["IN"])["roman"]
    prep = l1_to_l2.prepare_inputs(l1, config2, pack, area_factor, device=dev0)
    st = noise_core._Stages(prep, pack, config2)
    core = l1_to_l2.make_core(prep["plan"], dict(st.cfg, outputs=_OUTPUTS), prep["geom"])

    def realization(seed_j, arrs):
        arrs0 = st.simulate(seed_j, arrs)
        out = core(arrs0)
        data = arrs0["data"]
        return (data[-1] - data[1],
                out["slope"][act, act],
                torch.hypot(out["slope_err_read"], out["slope_err_poisson"])[act, act],
                PixelMask1.build(out["pdq"][act, act]))

    rate = np.asarray(x.truth_rate, np.float32)
    if config1.get("PERSISTENCE"):
        # truth_rate leaves out the persistence charge rate (run_config
        # adds it in the sim): the lanes simulate run_many's chain
        rate = rate + np.asarray(
            fits_lite.open_fits(config1["PERSISTENCE"])[0].data, np.float32)
    del x
    arr = noise_core.exposure_arrays(prep, rate)
    # every lane shares the SCA's arrays: stride-0 views, placed once per device
    lanes = parallel.shard_batch(mesh, parallel.broadcast_batch(arr, len(mesh)))

    acc = _Accumulator(nrun, nside, nside - 2 * nb)
    seed0 = int(config1["SEED"] if seed is None else seed)
    for b in range((nrun + len(mesh) - 1) // len(mesh)):
        take = min(len(mesh), nrun - b * len(mesh))
        res = parallel.run_stacked(
            mesh, lambda j, lane: realization(noise.lane_seed(seed0 + b, j), lane),
            lanes[:take])
        ld, img, err, masked = (t.cpu().numpy() for t in res)
        for j in range(take):
            acc.add(b * len(mesh) + j, ld[j], img[j], err[j], masked[j])

    stack = acc.stack(slope_ideal, nside, act)
    if outfile:
        fits_lite.PrimaryHDU(stack).writeto(outfile, overwrite=True)
    return stack


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    use_mesh = "--mesh" in argv
    device = None
    rest = []
    for a in argv:
        if a.startswith("--device="):
            device = a[len("--device="):]
        elif a != "--mesh":
            rest.append(a)
    if len(rest) < 3:
        print(
            "Calling format: python -m "
            "romanimpreprocess_tpu_torch.validation.many_realizations "
            "config1.yaml config2.yaml N [outfile.fits] [--mesh] [--device=cpu]"
        )
        return
    config1 = load_config(rest[0])
    config2 = load_config(rest[1])
    nrun = int(rest[2])
    outfile = rest[3] if len(rest) > 3 else config2["OUT"][:-5] + "_many_out.fits"
    if use_mesh:
        mesh = None if device is None else parallel.sca_mesh(devices=[device])
        run_many_mesh(config1, config2, nrun, outfile, mesh=mesh)
    else:
        run_many(config1, config2, nrun, outfile, device=device)


if __name__ == "__main__":
    main()
