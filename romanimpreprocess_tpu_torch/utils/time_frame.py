"""Check and time the frame IPC inverse (``ipc_cuda.ipc_rev2_frame``) on
one GPU.

    python romanimpreprocess_tpu_torch/utils/time_frame.py [--label NAME] [--runs N]

Imports ``romanimpreprocess_tpu_torch`` from ``sys.path``, so with
``PYTHONPATH`` set to another checkout the same script times that
checkout's kernel: run two checkouts in turns in one call (A, B, B, A)
to compare them on one card.  Each run first holds the wrapper against
its plain twin at ragged shapes (group counts above one register chunk,
frames narrower than one warp strip or a multiple of neither the strip
nor the segment, nborder 4, 2, 1 and 0, a NaN and infinities in the
border rows and columns the inverse reads), bit for bit with NaN at the
same places, then at the main path's shape (6 groups of 4096^2,
nborder 4).  The row-slab form (``ipc_cuda.ipc_rev2_rows``) is held the
same way: the frame cut into 2 to 5 row slabs with their halos
(``utils.rows.split_rows``), each slab's output bit for bit to its
twin and the slabs together bit for bit to the frame kernel's output.
It prints one JSON line: the card, each check's result,
at full size the CUDA-event median of ``--runs`` calls timed one by one
(``ms``: the wrapper's host work before its launch included, as
``chip_smoke.py`` times it) and of ``--runs`` batches of 10 calls
enqueued back to back (``ms_batched``, per call: the host work hidden
behind the previous launch), the least time the card could take (bytes
over the memory rate), the median of the two halves of the frame as
row slabs (``rows_ms``, both calls), and ``nvcc``'s register report of
the IPC kernels.  It exits non-zero, after that line, if a check failed.
"""

import argparse
import json
import statistics
import subprocess
import sys

#: H100 SXM memory rate, bytes/s (NVIDIA's data sheet)
HBM_RATE = 3.35e12


def _median_ms(fn, runs, batch=1):
    """Median over ``runs`` of ``batch`` calls between two CUDA events,
    per call."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def inputs(ngrp, nside, nb, gen, nonfinite=False):
    """Frame inverse inputs on the generator's device: a (ngrp, nside,
    nside) cube of negative and positive values, border-zeroed planes
    that sum to 1, a gain over the whole frame.  ``nonfinite``: a NaN
    and infinities in the outermost border rows and columns the inverse
    reads (inside the frame for nborder 0), which reach the output
    through their zero weights."""
    import torch

    dev = gen.device
    na = nside - 2 * nb
    planes = torch.zeros((9, nside, nside), device=dev)
    act = planes[:, nb : nside - nb, nb : nside - nb]
    act.copy_(torch.rand((9, na, na), generator=gen, device=dev) * 0.02)
    act[4] = 1.0 - (act.sum(0) - act[4])
    data = torch.rand((ngrp, nside, nside), generator=gen, device=dev) * 1500.0 - 500.0
    gain = 1.4 + 0.2 * torch.rand((nside, nside), generator=gen, device=dev)
    if nonfinite:
        e = min(nb, 2)
        lo, hi = nb - e, nb + na + e - 1
        data[0, lo, nside // 2] = float("nan")
        data[-1, hi, nb + na // 3] = -float("inf")
        data[ngrp // 2, nb + na // 2, lo] = float("inf")
    return data, planes, gain


def same_bits(a, b):
    """Equal bit patterns (signed zeros alike), NaN at the same places."""
    import torch

    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32),
        torch.where(nan, 0.0, b).view(torch.int32)))


def check(ngrp, nside, nb, gen, nonfinite=False):
    """The wrapper against the twin, bit for bit (:func:`same_bits`)."""
    import torch

    from romanimpreprocess_tpu_torch.ops import ipc_cuda

    data, planes, gain = inputs(ngrp, nside, nb, gen, nonfinite)
    got = ipc_cuda.ipc_rev2_frame(data, planes, gain, nb)
    ref = ipc_cuda.ipc_rev2_frame_plain(data, planes, gain, nb)
    fin = torch.isfinite(ref)
    return {"shape": [ngrp, nside, nside], "nborder": nb, "nonfinite": nonfinite,
            "bit_exact": same_bits(got, ref),
            "max_abs_err": (got - ref)[fin].abs().max().item()}


def slabs(data, planes, gain, n):
    """The frame's inputs cut into ``n`` row slabs with the least halo
    the inverse reads (``ipc_slab.NEUMANN_EXT`` rows): ``[(data, planes,
    gain, row0, lo, hi)]``, each slab contiguous."""
    from romanimpreprocess_tpu_torch.ops import ipc_slab
    from romanimpreprocess_tpu_torch.utils.rows import split_rows

    out = []
    for r in split_rows(data.shape[-2], n, ipc_slab.NEUMANN_EXT):
        rows = slice(r.y0, r.y0 + r.n)
        out.append((data[:, rows].contiguous(), planes[:, rows].contiguous(),
                    gain[rows].contiguous(), r.y0, r.lo, r.hi))
    return out


def check_rows(ngrp, nside, nb, n, gen, nonfinite=False):
    """The row-slab form on ``n`` slabs: each slab bit for bit to its
    twin, the slabs together bit for bit to the frame kernel."""
    import torch

    from romanimpreprocess_tpu_torch.ops import ipc_cuda

    data, planes, gain = inputs(ngrp, nside, nb, gen, nonfinite)
    frame = ipc_cuda.ipc_rev2_frame(data, planes, gain, nb)
    got, twin = [], []
    for d, p, g, row0, lo, hi in slabs(data, planes, gain, n):
        got.append(ipc_cuda.ipc_rev2_rows(d, p, g, nb, row0, lo, hi))
        twin.append(ipc_cuda.ipc_rev2_rows_plain(d, p, g, nb, row0, lo, hi))
    got = torch.cat(got, dim=1)
    twin = torch.cat(twin, dim=1)
    fin = torch.isfinite(twin)
    return {"shape": [ngrp, nside, nside], "nborder": nb, "slabs": n,
            "nonfinite": nonfinite,
            "bit_exact": same_bits(got, twin) and same_bits(got, frame),
            "max_abs_err": (got - twin)[fin].abs().max().item()}


def _ptxas(src):
    """``nvcc``'s lines for ``csrc/<src>`` naming each kernel and giving
    its registers, stack and spills, if built."""
    from romanimpreprocess_tpu_torch.ops import cuda_build

    log = cuda_build._target(src).with_suffix(".log")
    if not log.exists():
        return None
    return [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln or "Function properties" in ln]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_frame: no CUDA device")
    from romanimpreprocess_tpu_torch.ops import cuda_build, ipc_cuda

    cuda_build.build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    checks = [check(ngrp, nside, nb, gen, bad) for ngrp, nside, nb, bad in (
        (1, 20, 4, False), (6, 67, 4, True), (9, 131, 4, False), (17, 131, 4, True),
        (6, 1000, 4, False), (3, 1000, 2, True), (2, 67, 1, True), (5, 130, 0, False),
        (6, 4096, 4, True))]
    checks += [check_rows(ngrp, nside, nb, n, gen, bad) for ngrp, nside, nb, n, bad in (
        (1, 20, 4, 2, False), (6, 67, 4, 3, True), (9, 131, 4, 5, False),
        (17, 131, 2, 4, True), (3, 1000, 1, 3, True), (5, 130, 0, 2, False),
        (6, 4096, 4, 2, True), (6, 4096, 4, 3, False))]
    ngrp, nside, nb = 6, 4096, 4
    data, planes, gain = inputs(ngrp, nside, nb, gen)
    halves = slabs(data, planes, gain, 2)
    res = {"label": args.label, "card": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "shape": [ngrp, nside, nside],
           "bound_ms": ipc_cuda.bytes_moved(ngrp, nside) / HBM_RATE * 1e3,
           "ms": _median_ms(lambda: ipc_cuda.ipc_rev2_frame(data, planes, gain, nb),
                            args.runs),
           "ms_batched": _median_ms(
               lambda: ipc_cuda.ipc_rev2_frame(data, planes, gain, nb), args.runs, 10),
           "rows_ms": _median_ms(
               lambda: [ipc_cuda.ipc_rev2_rows(d, p, g, nb, r0, lo, hi)
                        for d, p, g, r0, lo, hi in halves], args.runs),
           "ptxas": {src: _ptxas(src) for src in cuda_build.SOURCES
                     if "ipc" in src and src != "ipc_fwd.cu"},
           "checks": checks}
    res["all_bit_exact"] = all(c["bit_exact"] for c in checks)
    print(json.dumps(res), flush=True)
    if not res["all_bit_exact"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
