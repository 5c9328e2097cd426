"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Prints the set-up split, the window's call count and the compared
numbers beside their limits on standard error, and one JSON line on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the end-to-end metrics, or with ``--trace 1`` the per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.
Exits non-zero, printing no result, without enough CUDA cards, when a
forbidden module (JAX or the JAX package) is loaded, or when the port is
not in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build cache of the run inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))

    from gpubench import harness, spec

    chips = spec.cell(spec.benchmark(ROOT), args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 3

    result, rows = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                               device="cuda", root=ROOT, t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for name, value, limit in rows:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
