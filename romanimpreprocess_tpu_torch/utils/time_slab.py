"""Check and time the slab IPC inverse's entry points on one GPU.

    python romanimpreprocess_tpu_torch/utils/time_slab.py [--label NAME] [--runs N]

Imports ``romanimpreprocess_tpu_torch`` from ``sys.path``, so with
``PYTHONPATH`` set to another checkout the same script times that
checkout's kernels: run two checkouts in turns in one call (A, B, B, A)
to compare them on one card.  Each run first holds every entry point
against the plain twin, bit for bit, at small ragged shapes (group
counts above one register chunk, frames narrower than one warp strip,
sizes that are multiples of neither the strip nor the segment; gain on
and off; raw and pre-padded planes), then at the main path's shape (6
groups of 4088^2, gain, planes pre-padded at ``th=32``), and prints one
JSON line: the card, the CUDA-event median of ``--runs`` launches of
each entry point, and the least time the card could take (bytes over
the memory rate).
"""

import argparse
import json
import statistics
import subprocess

#: H100 SXM memory rate, bytes/s (NVIDIA's data sheet)
HBM_RATE = 3.35e12
NB = 4


def _median_ms(fn, runs):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _inputs(ngrp, na, gen, with_gain, padded, th):
    import torch

    from romanimpreprocess_tpu_torch.ops import ipc_slab

    dev = torch.device("cuda")
    nside = na + 2 * NB
    K = torch.rand((3, 3, na, na), generator=gen, device=dev) * 0.02
    K[1, 1] = 1.0 - (K.sum(dim=(0, 1)) - K[1, 1])
    data = torch.rand((ngrp, nside, nside), generator=gen, device=dev) * 1000.0
    gain_frame = 1.4 + 0.2 * torch.rand((nside, nside), generator=gen, device=dev)
    gain = gain_frame[NB:-NB, NB:-NB] if with_gain else None
    kern = K
    if padded:
        kern = torch.from_numpy(
            ipc_slab.kernel_planes_padded(K.cpu().numpy(), th=th)).to(dev)
    return K, kern, data, gain


def _entries(ipc_slab, cube, kern, data, gain, th):
    calls = {
        "ipc_rev2_cube_blocked": lambda: ipc_slab.ipc_rev2_cube_blocked(
            cube, kern, gain, th=th),
        "ipc_rev2_cube_stream": lambda: ipc_slab.ipc_rev2_cube_stream(
            cube, kern, gain, th=th),
        "correct_cube_fused": lambda: ipc_slab.correct_cube_fused(
            data, kern, gain, nborder=NB, th=th),
    }
    if hasattr(ipc_slab, "correct_cube_stream"):
        calls["correct_cube_stream"] = lambda: ipc_slab.correct_cube_stream(
            data, kern, gain, nborder=NB, th=th)
    return calls


def check(ngrp, na, gen, with_gain=True, padded=True, th=32):
    """Every entry point against the twin, bit for bit; the frame forms'
    border passed through."""
    import torch

    from romanimpreprocess_tpu_torch.ops import ipc_slab

    K, kern, data, gain = _inputs(ngrp, na, gen, with_gain, padded, th)
    cube = data[:, NB:-NB, NB:-NB].contiguous()
    ref = ipc_slab.ipc_rev2_plain(cube, K.reshape(9, na, na), gain)
    frame = ipc_slab.correct_cube_plain(data, kern, gain, nborder=NB, th=th)
    for name, fn in _entries(ipc_slab, cube, kern, data, gain, th).items():
        got = fn()
        want = frame if name.startswith("correct") else ref
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(f"{name} {ngrp}x{na} gain={with_gain} "
                                 f"padded={padded}: not bit-identical (max {err})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_slab: no CUDA device")
    from romanimpreprocess_tpu_torch.ops import cuda_build, ipc_slab

    cuda_build.build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    for ngrp, na, with_gain, padded, th in (
            (3, 96, True, True, 16), (2, 100, False, False, 16), (1, 20, True, False, 8),
            (9, 67, True, True, 32), (17, 131, False, True, 32), (6, 1000, True, False, 8),
            (2, 1000, False, True, 32), (5, 29, True, True, 8)):
        check(ngrp, na, gen, with_gain, padded, th)
    na, ngrp = 4096 - 2 * NB, 6
    check(ngrp, na, gen)
    K, kern, data, gain = _inputs(ngrp, na, gen, True, True, 32)
    cube = data[:, NB:-NB, NB:-NB].contiguous()
    res = {"label": args.label, "card": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "shape": [ngrp, na, na],
           "bound_ms": ipc_slab.bytes_moved(ngrp, na) / HBM_RATE * 1e3}
    if hasattr(ipc_slab, "plan"):
        res["plan"] = ipc_slab.plan(na, ngrp, ipc_slab._resident(
            cuda_build.library("ipc_slab.cu"), cube.device,
            ipc_slab.plan(na, ngrp).chunk))._asdict()
    for name, fn in _entries(ipc_slab, cube, kern, data, gain, 32).items():
        res[name + "_ms"] = _median_ms(fn, args.runs)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
