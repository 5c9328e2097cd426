"""The readings that the limits of the comparison are set from.

    python3 gpubench/control.py --workload <cell> --seeds 1 2 3 ... [--calls 2]
                                [--out chiprun_out/control.json]

For each seed, in one process: the cell's inputs, then for ``--calls``
items drawn from the seed, one call of the entry that the window drives
(for ``l1_to_l2``: ``calibrate_tree`` + ``typefix.fix``), the plain
reference, and the entry's control: the reference one precision below
the configuration's, put in the program's place.  Prints and writes, per number, the program's
largest reading (the lower reading) and the control's smallest (the
upper reading).  The benchmark's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload, seeds, calls, device, overrides=None, log=sys.stderr):
    """{seed: {"program": numbers, "control": numbers}} of ``workload``."""
    import numpy as np
    import torch

    from gpubench import compare, spec

    bench = spec.benchmark(ROOT)
    wl = spec.cell(bench, workload)
    cfg = dict(spec.config(wl["config"]), **(overrides or {}))
    mix = spec.traffic(wl["traffic"])
    ent = spec.entry(cfg["entry"])
    ent.check(cfg)
    out = {}
    for seed in seeds:
        t0 = time.perf_counter()
        workdir = Path(ROOT / "build" / "gpubench_control" / workload)
        entry = ent.Entry(cfg, mix, seed, torch.device(device), workdir)
        rng = np.random.default_rng([int(seed) & (2**64 - 1), 6])
        pick = rng.choice(len(entry.items), size=min(calls, len(entry.items)), replace=False)
        prog, ctl = [], []
        for k in pick:
            item = entry.items[int(k)]
            tree = entry.call(item)
            ref = entry.reference(item)
            prog.append(entry.numbers(tree, ref))
            del tree
            ctl.append(entry.numbers(entry.control(item), ref))
            del ref
        out[seed] = {"program": compare.worst(prog), "control": compare.worst(ctl)}
        print(f"seed {seed} ({time.perf_counter() - t0:.1f} s): "
              f"program {out[seed]['program']}, control {out[seed]['control']}", file=log)
        del entry
    return out


def summary(out):
    """Per number: the program's largest reading and the control's smallest."""
    names = sorted({k for r in out.values() for k in r["program"]})
    return {k: {"lower": max(r["program"][k] for r in out.values()),
                "upper": min(r["control"][k] for r in out.values())} for k in names}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    out = readings(args.workload, args.seeds, args.calls, "cuda")
    res = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "seeds": {str(k): v for k, v in out.items()}, "summary": summary(out)}
    for k, v in res["summary"].items():
        print(f"{k}: lower {v['lower']!r}, upper {v['upper']!r}", file=sys.stderr)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
