"""Time the single-SCA calibration core (``l1_to_l2.make_core``) warm on
the card, and fingerprint its outputs, to compare two checkouts in one
call.

Usage, on a machine with a CUDA card::

    PYTHONPATH=<checkout> python romanimpreprocess_tpu_torch/utils/time_core.py --label X

``PYTHONPATH`` picks the checkout whose package is timed; to compare two,
run them in turns in one call (A, B, B, A).  The core runs on
``benchlib.core_bundle`` at ``--nside`` (default 4096, 6 groups) with
every backend ``auto`` (kernels A, B and C), once with the classic and
once with the likelihood fit: three warm-up calls, then the CUDA-event
median of ``--runs`` calls.  Prints one JSON line: the label, the
package's path, the card's ``nvidia-smi`` name and power limit, and for
each fit its median (``ms``) and the SHA-256 of its outputs' bytes in
key order (``sha256``: two checkouts whose cores give the same bits
print the same digest).  With ``--sky``, also the CUDA-event medians of
the core's sky steps alone on a seeded 4096^2 frame:
``sky.smooth_mode`` of its 4 x 4 bins, one bin in 35 NaN
(``smooth_mode_ms``), and ``sky.medfit`` of order 2 on its active
4088^2 (``medfit_ms``).
"""

import argparse
import hashlib
import json
import subprocess


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--nside", type=int, default=4096)
    ap.add_argument("--runs", type=int, default=9)
    ap.add_argument("--sky", action="store_true", help="also time the sky steps alone")
    args = ap.parse_args()

    import torch

    import romanimpreprocess_tpu_torch as pkg
    from romanimpreprocess_tpu_torch import benchlib
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2
    from romanimpreprocess_tpu_torch.utils.time_frame import _median_ms

    if not torch.cuda.is_available():
        raise SystemExit("time_core: no CUDA device")
    res = {"label": args.label, "package": pkg.__path__[0], "nside": args.nside,
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True).stdout.strip()}
    if args.sky:
        from romanimpreprocess_tpu_torch.ops import sky

        g = torch.Generator(device="cuda").manual_seed(0)
        slope = torch.randn((args.nside, args.nside), device="cuda", generator=g) * 3 + 20
        binned = sky.binkxk(slope, 4)
        binned[::7, ::5] = float("nan")
        act = slope[4:-4, 4:-4]
        res["smooth_mode_ms"] = _median_ms(lambda: sky.smooth_mode(binned), args.runs)
        res["medfit_ms"] = _median_ms(lambda: sky.medfit(act, order=2), args.runs)
        del slope, binned, act
    for name, likelihood in (("classic", False), ("likely", True)):
        arr, plan, cfg, geom = benchlib.core_bundle(nside=args.nside, likelihood=likelihood,
                                                    device="cuda")
        core = l1_to_l2.make_core(plan, cfg, geom)
        out = core(arr)
        digest = hashlib.sha256()
        for k in sorted(out):
            digest.update(k.encode())
            digest.update(out[k].detach().contiguous().cpu().numpy().tobytes())
        res[name] = {"ms": _median_ms(lambda: core(arr), args.runs),
                     "sha256": digest.hexdigest(), "ipc": cfg["ipc"]}
        del arr, out
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
