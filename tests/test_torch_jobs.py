"""The port's production job scripts (``runs/production_torch/``) on the CPU.

``OpenUniverse_to_L1L2.job`` runs under ``bash`` as Slurm would run it,
with ``DEVICE=cpu`` at 128^2 (one scene; ``EXTRA_ARGS`` gives a 5-group
``--reads`` and one noise layer): once as array task 4 (``--sca=4``) and
once in its one-task form (task 0: ``--sca=all --fpa``); both write the
same files, with finite L2 data.  ``make_sca_files.job``'s two Python
bodies run under ``bash`` with the job's own variables (``USE_SCA``,
``RAW_DIR``, ...) and ``DEVICE=cpu`` (the frame size, 128, is read from
the converted exposures): the first converts three raw dark
exposures of 12 frames and writes the solid-waffle configs; then the
files the external solid-waffle runs would make (noise summary, gain
summaries, the linearity file) are put in place, and the second body
builds the CALDIR set, which then calibrates an L1.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch
import yaml

from romanimpreprocess_tpu_torch import synth
from romanimpreprocess_tpu_torch.config import pattern_to_reads
from romanimpreprocess_tpu_torch.io import asdf_lite, fits_lite
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, sim_to_l1
from test_torch_calib import _noise_summary, _sw_summaries, _write_raw_frames

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(ROOT, "runs", "production_torch")
READ_PATTERN = [[0], [1, 2], [3, 4, 5], [6, 7, 8], [9, 10]]
N = 128
SCA = 4
KINDS = ("dark", "read", "gain", "ipc4d", "pflat", "saturation", "biascorr", "mask")


def _env(**kw):
    """The job's environment: this interpreter first on PATH, the
    checkout on PYTHONPATH, one CPU thread."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ["PATH"])
    env.pop("SLURM_ARRAY_TASK_ID", None)
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _bash(script, cwd, **kw):
    r = subprocess.run(["bash", "-c", script], cwd=cwd, env=_env(**kw),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs if f != "ou.lock")


def test_openuniverse_job_array_and_one_task_forms(tmp_path):
    d = str(tmp_path)
    os.makedirs(d + "/IN")
    os.makedirs(d + "/CAL")
    synth.make_scene_file(d + f"/IN/Roman_Test_truth_F184_163_{SCA}.fits",
                          nside_active=N - 8, nstars=3)
    synth.make_cal_files(d + "/CAL/roman_wfi", READ_PATTERN, nside=N, seed=5, tag="T",
                         sca=SCA)
    job = os.path.join(JOBS, "OpenUniverse_to_L1L2.job")
    reads = ",".join(map(str, pattern_to_reads(READ_PATTERN)))
    common = dict(IN_DIR=d + "/IN", CAL_DIR=d + "/CAL", TAG="T", DEVICE="cpu",
                  EXTRA_ARGS=f"--reads={reads} --layers=Rz4OS2C2")
    _bash(f"bash {job}", d, OUT_DIR=d + "/OUT_A", SLURM_ARRAY_TASK_ID=SCA, **common)
    _bash(f"bash {job}", d, OUT_DIR=d + "/OUT_F", SLURM_ARRAY_TASK_ID=0, **common)
    files = _files(d + "/OUT_A")
    stem = f"F184_163_{SCA}"
    for f in (f"L1/sim_L1_{stem}.asdf", f"L2/sim_L2_{stem}.asdf",
              f"L2/sim_L2_{stem}_noise.asdf"):
        assert f in files, (f, files)
    assert _files(d + "/OUT_F") == files
    for out in ("OUT_A", "OUT_F"):
        data = np.asarray(asdf_lite.open(f"{d}/{out}/L2/sim_L2_{stem}.asdf")["roman"]["data"])
        assert data.shape == (N - 8, N - 8) and np.isfinite(data).all()


def _job_parts(path):
    """The job's shell prologue (up to its first Python body) and each
    ``python - <<PYEOF ... PYEOF`` body with its heredoc lines."""
    text = open(path).read()
    bodies = re.findall(r"^python - <<PYEOF\n.*?^PYEOF\n", text, flags=re.S | re.M)
    return text[: text.index(bodies[0])], bodies


def test_make_sca_files_job_bodies(tmp_path):
    d = str(tmp_path)
    raw, target = d + "/raw", d + "/target"
    os.makedirs(raw)
    os.makedirs(target)
    naug = N + N // 32
    rng = np.random.RandomState(77)
    dark_slope = 0.05 * 10.0 ** rng.normal(-0.3, 0.5, (N, naug))
    bias = 12000 + 100 * np.cos(np.arange(naug) / 17.0)[None, :]
    for e in range(1, 4):
        frames = _write_raw_frames(d, 12, np.random.RandomState(e), dark_slope, bias)
        for k, f in enumerate(frames):
            # the test campaign's names: ..._exp{j}_...SCU{nn}...{hex}.fits
            shutil.move(f, f"{raw}/Test_exp{e}_SCU{SCA:02d}_{k:03d}0.fits")
    prologue, bodies = _job_parts(os.path.join(JOBS, "make_sca_files.job"))
    assert len(bodies) == 2
    env = dict(USE_SCA=SCA, RAW_DIR=raw, TARGET_DIR=target, TAG="PROD",
               PATTERN="TESTPAT", NFRAMES=12, DEVICE="cpu")

    _bash(prologue + bodies[0], d, **env)
    noise = sorted(f for f in os.listdir(target) if "_Noise_" in f)
    assert noise == [f"99999999_SCA{SCA:02d}_Noise_{e:03d}.fits" for e in (1, 2, 3)]
    assert len(open(f"{d}/summary_files_{SCA:02d}.txt").read().split()) == 5
    assert os.path.exists(f"{d}/linearity_cfg_{SCA:02d}.json")
    cube = fits_lite.open_fits(f"{target}/{noise[0]}")[1].data
    assert cube.shape[-2:] == (N, naug)

    # what the external solid-waffle runs would write
    _noise_summary(f"{target}/noise_summary_SCA{SCA:02d}.fits", dark_slope)
    with open(f"{d}/summary_files_{SCA:02d}.txt", "w") as f:
        f.write("\n".join(_sw_summaries(d)) + "\n")
    syn = synth.make_cal_files(d + "/syn", READ_PATTERN, nside=N, seed=9, tag="SYN",
                               sca=SCA)
    shutil.copy(syn["linearitylegendre"],
                f"{target}/roman_wfi_linearitylegendre_PROD_SCA{SCA:02d}.asdf")
    with open(f"{d}/settings_TESTPAT.yaml", "w") as f:
        yaml.safe_dump({"READS": pattern_to_reads(READ_PATTERN)}, f)

    _bash(prologue + bodies[1], d, **env)
    cal = {k: f"{target}/roman_wfi_{k}_PROD_SCA{SCA:02d}.asdf" for k in KINDS}
    for k, p in cal.items():
        assert os.path.exists(p), k
    cal["flat"] = cal.pop("pflat")
    cal["linearitylegendre"] = syn["linearitylegendre"]

    # the produced set calibrates an L1
    scene = synth.make_scene_file(d + "/truth_F184_163_4.fits", nside_active=N - 8,
                                  nstars=3)
    sim_to_l1.run_config({"IN": scene, "OUT": d + "/L1.asdf", "CALDIR": cal,
                          "READS": pattern_to_reads(READ_PATTERN), "SEED": 3},
                         device="cpu")
    l1_to_l2.calibrateimage({"IN": d + "/L1.asdf", "OUT": d + "/L2.asdf", "CALDIR": cal,
                             "SKYORDER": 2}, device="cpu")
    im = asdf_lite.open(d + "/L2.asdf")["roman"]
    good = np.asarray(im["dq"]) == 0
    assert good.mean() > 0.5 and np.isfinite(np.asarray(im["data"])[good]).all()
