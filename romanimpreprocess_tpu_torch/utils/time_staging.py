"""Time the per-call copy to the card (``io/staging.stage``, uncached) and
its parts, on the three large per-call arrays of one L1 -> L2 call.

Usage, on a machine with a CUDA card::

    PYTHONPATH=<checkout> python romanimpreprocess_tpu_torch/utils/time_staging.py --label X

The arrays are those of ``l2_classic``'s call at ``--nside`` (default
4096): the (8, n, n) uint16 L1 cube, the (8, n, 128) uint16 amp33 and
the float32 area map, 343.97 MB on the wire at 4096; two such sets in
turn, so that no run reads a source the run before it read (a call
reads a new exposure).  Medians of ``--runs`` after two warm-up runs,
each with its rate in GB/s:

- ``stage_ms``: host wall of ``stage(..., cache=False)`` over the three
  (what the caller waits for); ``stage_sync_ms``: to the end of their
  device copies (a sync after);
- ``pageable_ms``: the same bytes sent from pageable memory
  (``send(from_host(a))``, a sync after);
- ``fill_ms``: the host's copy of the three into page-locked blocks
  alone, on torch's intra-op threads (``threads``);
- ``dma_ms``: the device copies from filled page-locked blocks alone
  (CUDA events).

Prints one JSON line, with the card's ``nvidia-smi`` name and power
limit.
"""

import argparse
import json
import statistics
import subprocess
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--nside", type=int, default=4096)
    ap.add_argument("--runs", type=int, default=9)
    args = ap.parse_args()

    import numpy as np
    import torch

    from romanimpreprocess_tpu_torch.io import staging

    if not torch.cuda.is_available():
        raise SystemExit("time_staging: no CUDA device")
    n, dev = args.nside, torch.device("cuda")
    rng = np.random.default_rng(0)
    host = [[rng.integers(0, 2**16, (8, n, n), dtype=np.uint16),
             rng.integers(0, 2**16, (8, n, 128), dtype=np.uint16),
             rng.random((n, n), dtype=np.float32)] for _ in range(2)]
    wire = [[staging.from_host(a) for a in arrays] for arrays in host]
    nbytes = sum(w.nbytes for w in wire[0])
    blocks = [torch.empty(w.shape, dtype=w.dtype, pin_memory=True) for w in wire[0]]
    dsts = [torch.empty(w.shape, dtype=w.dtype, device=dev) for w in wire[0]]

    def walls(fn):
        """Median host wall to ``fn(i)``'s return and to a sync after it,
        ms, where run ``i`` reads set ``i % 2``."""
        ret, done = [], []
        for i in range(args.runs + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(i % 2)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i >= 2:
                ret.append(1e3 * (t1 - t0))
                done.append(1e3 * (t2 - t0))
        return statistics.median(ret), statistics.median(done)

    def dma():
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for d, b in zip(dsts, blocks):
            d.copy_(b, non_blocking=True)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    res = {"label": args.label, "nside": n, "mb": nbytes / 1e6,
           "threads": torch.get_num_threads(),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True).stdout.strip()}
    res["stage_ms"], res["stage_sync_ms"] = walls(
        lambda i: [staging.stage(a, dev, cache=False) for a in host[i]])
    res["pageable_ms"] = walls(lambda i: [staging.send(w, dev) for w in wire[i]])[1]
    res["fill_ms"] = walls(lambda i: [b.copy_(w) for b, w in zip(blocks, wire[i])])[0]
    dma()
    res["dma_ms"] = statistics.median(dma() for _ in range(args.runs))
    for k in ("stage_ms", "stage_sync_ms", "pageable_ms", "fill_ms", "dma_ms"):
        res[k.replace("_ms", "_gb_s")] = nbytes / res[k] / 1e6
    print(json.dumps(res))


if __name__ == "__main__":
    main()
