"""No module that a run loads has the top-level name ``jax`` or
``romanimpreprocess_tpu`` (whole names: the port's name begins with the
JAX package's), and ``run.py`` prints no result without a card."""

import json
import subprocess
import sys

from conftest import ROOT

DRIVE = """
import io, json, sys
sys.path.insert(0, {root!r})
from gpubench import harness
result, rows = harness.run("l2_classic.sca1", 12345, 0.3, True, device="cpu",
                           overrides={{"nside": 128, "channelwidth": 4}}, log=io.StringIO())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    r = subprocess.run([sys.executable, "-c", DRIVE.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "romanimpreprocess_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "romanimpreprocess_tpu"}


def test_run_without_a_card_prints_no_result():
    r = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "l2_classic.sca1",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
