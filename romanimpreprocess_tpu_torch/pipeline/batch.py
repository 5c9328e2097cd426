"""Batch orchestration: many exposures, or the whole focal plane.

Equivalent of the reference's production driver
(``runs/summer2025run/OpenUniverse_to_L1L2.py:1-169``), which runs one
Slurm array task per SCA and loops exposures serially.  Same CLI
surface (``--key=value`` flags, FileLock'd directory creation, per-SCA
seed spacing ``seed += dseed * nsca``); besides, one process can sweep
all 18 SCAs of each exposure over a mesh of devices
(:mod:`..parallel`).

Usage::

    python -m romanimpreprocess_tpu_torch.pipeline.batch \\
        --in=IN_DIR --out=OUT_DIR --cal=CAL_DIR --tag=TAG \\
        [--sca=N | --sca=all] [--seed=500] [--dseed=10] [--nmax=999] \\
        [--reads=0,1,1,2,...] [--layers=Rz4PbrS2C1,...] [--fpa] [--device=cpu]

``--fpa`` processes each exposure's SCAs as one focal-plane batch
(threaded sims, one :func:`..parallel.calibrate_fpa` over the mesh,
noise and masks on two workers) instead of the serial per-SCA loop; the
files are the same.  ``--device`` names the one device to run on
(default: every CUDA device with ``--fpa``, ``cuda`` otherwise; raises
without a GPU).  ``--layers=`` (empty) draws no noise.
"""

import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

from .. import parallel
from ..config import resolve_device
from ..ops.mask import PixelMask1
from . import l1_to_l2, noise, sim_to_l1

NSCA = 18

DEFAULT_READS = [0, 1, 1, 2, 2, 4, 4, 10, 10, 26, 26, 32, 32, 34, 34, 35]
DEFAULT_LAYERS = [
    "Rz4PbrS2C1", "Rz4PbrS2C2", "Rz4PbrS2C3", "Rz4PbrS2C4",
    "Rz4OS2C5", "Rz4OS2C6", "Rz4OS2C7", "Rz4OS2C8",
]

L1_CTYPES = ["linearitylegendre", "gain", "dark", "read", "ipc4d", "flat",
             "biascorr"]
L2_CTYPES = L1_CTYPES + ["saturation", "mask"]


def getval(argv, key, default=None):
    """--key=value flag lookup (reference ``OpenUniverse_to_L1L2.py:15-20``)."""
    prefix = f"--{key}="
    for a in argv:
        if a.startswith(prefix):
            return a[len(prefix):]
    return default


def findcal(cal_dir, tag, ctype, sca):
    """Calibration file locator (``findcal``, reference :64-70)."""
    ctype_ = "pflat" if ctype == "flat" else ctype
    return f"{cal_dir}/roman_wfi_{ctype_}_{tag}_SCA{sca:02d}.asdf"


def scan_inputs(input_dir, use_scas):
    """Scan the input dir for ``*_<band>_<obsid>_<sca>.fits`` truth files."""
    out = []
    for infile in sorted(os.listdir(input_dir)):
        if not infile.lower().endswith(".fits"):
            continue
        m = re.match(r".*_([A-Za-z0-9]+)_(\d+)_(\d+)\.fits$", infile,
                     flags=re.IGNORECASE)
        if not m:
            continue
        band, obsid, sca = m.group(1), int(m.group(2)), int(m.group(3))
        if sca not in use_scas:
            continue
        out.append((os.path.join(input_dir, infile), band, obsid, sca))
    return out


def build_configs(infile, band, obsid, sca, *, output_dir, cal_dir, tag,
                  seed, temp_dir, reads=None, layers=None, dseed=10):
    """(L1 config, L2+noise config) for one exposure/SCA.

    The noise SEED is ``seed + dseed * NSCA``: the reference advances
    the running seed by one ``dseed * nsca`` step between the L1 and
    NOISE configs of each exposure (``OpenUniverse_to_L1L2.py:108,135``),
    keeping every seed on the dseed lattice (a plain ``seed + 1`` could
    collide with another SCA's L1 seed).
    """
    reads = reads or DEFAULT_READS
    layers = layers if layers is not None else DEFAULT_LAYERS
    stem = f"{band}_{obsid}_{sca}"
    c1 = {
        "IN": infile,
        "OUT": f"{output_dir}/L1/sim_L1_{stem}.asdf",
        "READS": list(reads),
        "FITSOUT": False,
        "CALDIR": {c: findcal(cal_dir, tag, c, sca) for c in L1_CTYPES},
        "CNORM": 1.0,
        "SEED": seed,
    }
    c2 = {
        "IN": c1["OUT"],
        "OUT": f"{output_dir}/L2/sim_L2_{stem}.asdf",
        "FITSWCS": f"{output_dir}/L1/sim_L1_{stem}_asdf_wcshead.txt",
        "CALDIR": {c: findcal(cal_dir, tag, c, sca) for c in L2_CTYPES},
        "RAMP_OPT_PARS": {"slope": 0.4, "gain": 1.8, "sigma_read": 7.0},
        "JUMP_DETECT_PARS": {
            "SthreshA": 5.5, "SthreshB": 4.5, "IthreshA": 0.6,
            "IthreshB": 600.0,
        },
        "SKYORDER": 2,
        "FITSOUT": False,
    }
    if layers:
        c2["NOISE"] = {
            "LAYER": list(layers),
            "TEMP": f"{temp_dir}/temp_{stem}.asdf",
            "SEED": seed + dseed * NSCA,
            "OUT": f"{output_dir}/L2/sim_L2_{stem}_noise.asdf",
        }
    return c1, c2


def plan_jobs(scanned, *, output_dir, cal_dir, tag, seed, dseed,
              temp_dir, reads=None, layers=None, nmax=999):
    """Scanned inputs -> (c1, c2) config pairs with the reference
    driver's seed sequence.

    Seeds (``OpenUniverse_to_L1L2.py:49,108,141``): a single-SCA task
    starts at ``seed0 + dseed*sca`` and advances the running seed by
    ``dseed*NSCA`` twice per exposure (after the L1 config and after the
    NOISE config), so SCA k's i-th exposure draws L1 seed ``seed0 +
    dseed*(k + 2*i*NSCA)`` and noise seed one lattice step later: a
    ``--sca=all`` sweep emits exactly the seeds of 18 reference tasks.
    ``nmax`` bounds exposures PER SCA, like the reference's Nmax on each
    single-SCA task (:148-152), so no exposure loses part of its focal
    plane.  Returns ``(kept_inputs, jobs)``.
    """
    inputs, nkept = [], {}
    for item in scanned:
        sca = item[3]
        if nkept.get(sca, 0) >= nmax:
            continue
        nkept[sca] = nkept.get(sca, 0) + 1
        inputs.append(item)

    jobs = []
    iexp = {}
    for infile, band, obsid, sca in inputs:
        i = iexp.get(sca, 0)
        iexp[sca] = i + 1
        s = seed + dseed * (sca + 2 * i * NSCA)
        jobs.append(build_configs(
            infile, band, obsid, sca, output_dir=output_dir,
            cal_dir=cal_dir, tag=tag, seed=s, temp_dir=temp_dir,
            reads=reads, layers=layers, dseed=dseed,
        ))
    return inputs, jobs


def _mask_path(c2):
    return c2["OUT"][:-5] + "_mask.fits"


def process_exposure(c1, c2, write_mask=True, device=None):
    """sim -> L1 -> L2 (-> noise -> mask) for one exposure/SCA on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    sim_to_l1.run_config(c1, device=device)
    l1_to_l2.calibrateimage(c2 | {"SLICEOUT": True}, device=device)
    if "NOISE" in c2:
        noise.generate_all_noise(c2, device=device)
    if write_mask:
        PixelMask1.convert_file(c2["OUT"], _mask_path(c2))


def process_exposure_fpa(jobs, mesh=None, write_mask=True, sim_workers=4):
    """One exposure's SCAs as a focal-plane batch (``--fpa``) over
    ``mesh`` (default :func:`..parallel.sca_mesh`).

    The sims run on a thread pool of ``sim_workers`` (so at most that
    many cubes are on the devices at once), SCA ``i`` on mesh entry ``i
    % len(mesh)``; then one :func:`..parallel.calibrate_fpa` covers every
    SCA; then the noise and the masks on two workers (one SCA's file
    writes overlap the next one's device work).  The files are those of
    :func:`process_exposure`, bit for bit but for the L2 log's
    ``Timing:`` line.
    """
    mesh = parallel.sca_mesh() if mesh is None else mesh

    def on_entry(i, fn):
        dev = mesh[i % len(mesh)]
        with parallel.device_context(dev):
            fn(dev)

    with ThreadPoolExecutor(max_workers=sim_workers) as pool:
        list(pool.map(lambda i: on_entry(i, lambda dev: sim_to_l1.run_config(
            jobs[i][0], device=dev)), range(len(jobs))))
    c2s = [c2 | {"SLICEOUT": True} for _, c2 in jobs]
    parallel.calibrate_fpa(c2s, mesh=mesh)

    def noise_mask_one(i):
        c2 = jobs[i][1]  # the noise file records the config as the serial path does
        if "NOISE" in c2:
            on_entry(i, lambda dev: noise.generate_all_noise(c2, device=dev))
        if write_mask:
            PixelMask1.convert_file(c2["OUT"], _mask_path(c2))

    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(noise_mask_one, range(len(c2s))))


def run(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    input_dir = getval(argv, "in")
    output_dir = getval(argv, "out", ".")
    cal_dir = getval(argv, "cal")
    tag = getval(argv, "tag")
    seed = int(getval(argv, "seed", "500"))
    dseed = int(getval(argv, "dseed", "10"))
    temp_dir = os.getenv("TMPDIR", output_dir + "/L2")
    sca_arg = getval(argv, "sca", "1")
    nmax = int(getval(argv, "nmax", "999"))
    reads_arg = getval(argv, "reads")
    layers_arg = getval(argv, "layers")
    device_arg = getval(argv, "device")
    fpa = getval(argv, "fpa") is not None or "--fpa" in argv
    reads = [int(x) for x in reads_arg.split(",")] if reads_arg else None
    layers = layers_arg.split(",") if layers_arg is not None else None
    if layers == [""]:
        layers = []

    use_scas = list(range(1, NSCA + 1)) if sca_arg == "all" else [int(sca_arg)]
    if fpa:
        # one mesh for the whole sweep
        mesh = parallel.sca_mesh(devices=None if device_arg is None else [device_arg])
    else:
        device = resolve_device(device_arg)

    # FileLock'd directory creation (many tasks may race on a shared FS)
    try:
        from filelock import FileLock

        lock = FileLock(os.path.join(output_dir, "ou.lock"))
    except ImportError:
        import contextlib

        lock = contextlib.nullcontext()
    with lock:
        for sub in ("L1", "L2"):
            os.makedirs(os.path.join(output_dir, sub), exist_ok=True)
        os.makedirs(temp_dir, exist_ok=True)

    inputs, jobs = plan_jobs(
        scan_inputs(input_dir, use_scas), output_dir=output_dir,
        cal_dir=cal_dir, tag=tag, seed=seed, dseed=dseed,
        temp_dir=temp_dir, reads=reads, layers=layers, nmax=nmax,
    )
    print(f"{len(inputs)} exposures on {list(map(str, mesh)) if fpa else device}")

    if fpa:
        groups = {}
        for (infile, band, obsid, sca), job in zip(inputs, jobs):
            groups.setdefault((band, obsid), []).append(job)
        for (band, obsid), exposure_jobs in groups.items():
            print(f"Processing exposure {band}_{obsid} "
                  f"({len(exposure_jobs)} SCAs, FPA batch)")
            sys.stdout.flush()
            process_exposure_fpa(exposure_jobs, mesh=mesh)
        return

    for c1, c2 in jobs:
        print("Processing", c1["IN"])
        sys.stdout.flush()
        process_exposure(c1, c2, device=device)


if __name__ == "__main__":
    run()
