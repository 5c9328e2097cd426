#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit; the kernels are built from
   ``romanimpreprocess_tpu_torch/csrc`` into ``build/torch_ext/``.
2. kernels: each hand-written CUDA kernel (linearity, block nanmedian,
   forward IPC, pink-noise transform, read contraction, the bisection
   inverse of the linearity, and the
   row-streaming IPC inverse: in the slab order behind its three entry
   points, blocked, streaming, fused full frame, and in the Neumann
   order as the frame inverse of the auto route) against its plain
   PyTorch version on the card, at the main paths' shapes (4096^2 x 6
   groups; the 4088^2 active frame; 14 reads; 102 transforms of 2^20;
   the inverse at 8 x 4088^2 with 7 coefficients, the production lane's)
   and at small ragged shapes that take every size branch (the block
   nanmedian's clusters of 1, 2, 4 and 8 CTAs and its streaming kernel,
   on noise and on duplicates, signed zeros and infinities; the pink
   transform's wgmma and mma.sync paths; the IPC kernel's group chunks,
   strips and segments, and the frame inverse at nborder 4, 2 and 0 and
   with a NaN and infinities in the border rows and columns it reads;
   its row-slab form on 2 to 5 slabs, each slab bit for bit to its twin
   and the slabs together to the frame form, at 4096^2 in two slabs; the
   slab routes' row form likewise against ``correct_cube_fused``);
   CUDA-event medians of the kernel, the plain version and, where one
   exists, a single PyTorch call computing the same function; the least
   time the card could take (bytes over the memory rate, operations
   over the peak rate for their type).
3. plain devices: the port's plain path on ``cuda`` held to the same
   path on ``cpu`` at 128^2 (``utils/parity.py`` ``plain_devices``):
   ``calibrateimage`` with the classic fit and the core with the
   likelihood fit on the slab route's twin at the slice's gates; the
   example noise layers at the spread gates; the sim's resultants over 8 seeds at the moment gates, and sim -> L1 ->
   L2 at the envelope gates, on each device.
4. main path, L1 -> L2: a synthetic 4096^2 CALDIR and 6-group L1 through
   ``calibrateimage`` on ``cuda`` with every backend ``auto``
   (SKYORDER 2, SLICEOUT), kernel launch counts read around that run;
   the L2 checked (finite, DQ populated, injected rate recovered) and
   held against the plain path on the card (every backend ``xla``);
   the warm core timed with CUDA events, kernels and plain path in
   turns, and profiled (the ``ipc`` stage's device time printed).
4b. row-sharded calibration (``parallel.spatial``): the classic phase's
   CALDIR and L1 through ``prepare_inputs`` (every backend ``auto``) and
   the row-sharded core on a one-card mesh of two entries (``cuda:0``
   twice; kernels A, B in its row-slab form, C), launch counts and the
   gathered bytes read around that call; held to the single core on the
   same bundle at the JAX package's ``tests/test_spatial.py`` gate
   (``parity.row_shard_gate``, the measured drift per output printed);
   the warm call and the single core timed (CUDA-event medians of 5);
   again with the likelihood fit, and on three entries (uneven slabs);
   the likelihood fit under ``IPC_BACKEND: pallas`` and ``pallas-stream``
   (kernels 6 and 5 in their row form) on two entries.
5. noise engine: the classic phase's CALDIR and its L1 with sources
   added (10% of the pixels 100 DN/s brighter) through
   ``noise.generate_all_noise`` with the example layers
   ``['Rz4PbrS2C1', 'Rz4OS2C2']`` (seed 15000, ``device-strict``, every
   backend ``auto``, ``CONTRACT_BACKEND: pallas``), launch counts and
   Pearson type-4 rejection rounds read around that call; the cube
   checked (shape, finite, the same seed twice gives the same cube),
   held to the plain path (``xla`` / ``dot``) at the spread gates
   (``utils/parity.py`` ``compare_noise``), its 'O' layer to the
   signal; the warm runner (``noise_core.make_staged_noise_runner``)
   timed with CUDA events, kernels and plain path in turns, and
   profiled; the likelihood fit under ``IPC_BACKEND: pallas-stream``
   once, so that kernel 5 serves the re-entries.
6. main path, L1 -> L2 with the likelihood fit: the same CALDIR and L1
   through ``calibrateimage`` with ``romancal_ramp_fit: True``, once
   with ``IPC_BACKEND: pallas`` (the slab kernel through the blocked
   entry's fused full-frame form) and once with ``pallas-stream`` (the
   streaming entry's frame form), launch counts read around each run; ``dumo``
   and ``chisq`` checked; the two L2 trees held bit for bit against each
   other and against the plain route (the slab twin, ``LIN``/``SKY``
   ``xla``), and within the slice tolerances against the frame route
   (``pallas-frame``; the sky within the bound the maps' measured
   difference puts on it, ``parity.sky_bounds``), whose core outputs are held bit for bit against
   its own plain route (the frame twin, ``IPC``/``LIN``/``SKY``
   ``xla``); the warm core timed and profiled.
7. main path, sim -> L1: a 4088^2 truth scene and the same CALDIR
   through ``sim_to_l1.run_config`` on ``cuda`` (6 groups, 14 reads;
   ``IPC_BACKEND``/``LIN_BACKEND``/``PINK_BACKEND`` ``auto``, ``CONTRACT_BACKEND:
   pallas``), launch counts read around that run; the L1 file checked
   and fed to ``calibrateimage`` (slope recovery, CR envelope and
   recall); the same seed again with every backend ``xla``/``dot`` and
   the two cubes held within 1 DN; the warm sim timed and profiled on
   both paths.

8. the focal plane (``parallel``, ``pipeline/batch``,
   ``validation/many_realizations``) on the card's mesh, every backend
   ``auto`` and ``CONTRACT_BACKEND: pallas``: the exposure runner
   (``make_fpa_exposure_runner``) over 18 lanes at 4096^2 x 6 groups with
   the 8 production layers (``batch.DEFAULT_LAYERS``), the classic
   phase's CALDIR shared and staged once, 18 rate maps from ``synth``
   seeds 0-17; warmed with 2 lanes, then the 18-lane call timed (wall,
   per lane, peak memory) with launch counts read around it; lanes 0
   and 17 held bit for bit to single-SCA runs at their ``lane_seed``,
   the 2-lane call to the first two lanes, lane 0 to the plain path at
   the spread gates.  ``calibrate_fpa`` of two SCAs on two CALDIR paths
   (one a symlinked copy), each written file held bit for bit to
   ``calibrateimage``'s.  ``batch.run`` of one SCA with its own cal
   set, serially and with ``--fpa``: identical files.  The Monte-Carlo
   drivers on the sim phase's scene (``run_many_mesh`` 4 realizations,
   ``run_many`` 2) at the JAX package's validation gates.
9. calibration-file production (``calib``) at 4096^2: ``fit_linearity``
   on two flat ramps (15 and 20 frames) made by the inverse linearity
   from the toy curve of ``tests/test_characterize.py`` (recovery at the
   JAX test's gate; the CPU's fit on a 128-row slab; time, peak
   memory); ``sigma_clip_mean`` over 100 dark frames of 4096 x 4224 with
   hits and NaN (the CPU's clip on a slab: survivor counts equal, means
   within rtol 1e-6); the chain of ``runs/production/make_sca_files.job``
   from per-frame raw FITS (3 dark exposures in the 6-group pattern)
   through convert, the dark/read, gain/IPC, linearity, p-flat,
   saturation, bias-correction and mask writers (disk peak printed),
   and the main path's L1 calibrated with the produced files in place
   of the synthetic ones (finite data on the good pixels).

Then the ``{"kernels": [...]}`` line (with each kernel's launches in
the 18-lane call, ``fpa_launches``, and in the row-sharded core on two
entries, ``spatial_launches``, and under the slab routes,
``spatial_slab_launches``), the ``nvidia-smi`` name/power
line, and as the last line ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before that line.  There is no CPU path: without
CUDA, or outside a checkout of the repository, the script fails.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NSIDE = 4096
NB = 4
NGRP = 6

#: memory rate (bytes/s) by card name, from NVIDIA's data sheets
HBM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))
#: float32 rate outside the tensor cores (H100 SXM data sheet)
F32_RATE = 67e12
#: dense bfloat16 rate of the tensor cores (H100 SXM data sheet)
BF16_RATE = 989e12


class SmokeError(RuntimeError):
    pass


def require(cond, what):
    if not cond:
        raise SmokeError(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def hbm_rate(name):
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    raise SmokeError(f"no memory rate known for {name!r}")


def bound(nbytes, nops, name, ops_rate=F32_RATE):
    """(bound_ms, bound_by): the larger of bytes / memory rate and
    operations / the peak rate for their type."""
    t_bytes = nbytes / hbm_rate(name) * 1e3
    t_ops = nops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, runs=10, warmup=2):
    """Median over ``runs`` of one call timed with CUDA events."""
    import torch

    for _ in range(warmup):
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


#: substrings of the port's kernel names in a profile: the frame inverse
#: (B) is ipc_slab_kernel<G, NeumannOrder>, the slab entries (4-6)
#: ipc_slab_kernel<G, SlabOrder>
L2_KERNEL_NAMES = ("linearity_kernel", "NeumannOrder", "block_nanmedian", "SlabOrder")
SIM_KERNEL_NAMES = ("ipc_fwd_kernel", "pink_", "contract_kernel", "invlin_kernel")
NOISE_KERNEL_NAMES = L2_KERNEL_NAMES + ("pink_", "contract_kernel")
#: the port's ``torch.profiler`` ranges (``profiling.StageRanges`` and the
#: noise runner's), whose copies on the GPU timeline are not kernels
RANGE_PREFIXES = ("l1_to_l2.", "sim_to_l1.", "noise.")


def profile(fn, top=10, prefix="l1_to_l2", ours=L2_KERNEL_NAMES):
    """One warm call under torch.profiler: device time per stage of the
    function (its ``<prefix>.*`` ranges; a range nested in another is
    listed beside it) and per kernel name, the kernel count, and the
    device's idle share of the span from the first kernel's start to
    the last one's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device events, less the stage ranges' own copies on the GPU timeline
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(RANGE_PREFIXES)]
    if not kern:
        return {"wall_ms": wall_ms, "device_time": "not measured (no CUDA events)"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    span_us = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in kern:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    names = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)

    stages = {e.key.split(".", 1)[1]: dev_us(e) / 1e3 for e in prof.key_averages()
              if e.key.startswith(prefix + ".")}
    ours = {name: sum(t for k, (t, _) in by_name.items() if name in k) / 1e3
            for name in ours}
    return {"wall_ms_profiled": wall_ms, "device_span_ms": span_us / 1e3,
            "device_busy_ms": busy / 1e3, "idle_share": 1.0 - busy / span_us,
            "n_kernels": len(kern), "stage_device_ms": stages,
            "port_kernels_ms": ours,
            "top_kernels": [{"name": k[:90], "ms": t / 1e3, "calls": n}
                            for k, (t, n) in names]}


def smi_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Phase 2: the kernels against their plain versions
# --------------------------------------------------------------------------

def lin_inputs(shape, ncoef, gen, dev):
    """Random linearity inputs: a pixel mix that interpolates,
    extrapolates (also in later groups, so the DQ feedback runs) and
    carries NO_LIN_CORR / REFERENCE_PIXEL calibration flags."""
    import torch

    from romanimpreprocess_tpu_torch.dqflags import i32, pixel
    from romanimpreprocess_tpu_torch.ops.linearity import LinearityData

    ngrp, ny, nx = shape

    def rand(*s):
        return torch.rand(s, generator=gen, device=dev)

    scale = torch.tensor([0.0, 3e4, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                         device=dev)[:ncoef, None, None]
    coefs = (torch.randn((ncoef, ny, nx), generator=gen, device=dev) * 100.0
             + scale).contiguous()
    smin = rand(ny, nx) * 100.0
    smax = smin + 40000.0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    dq = (torch.where(rand(ny, nx) < 0.05, i32(pixel.NO_LIN_CORR), zero)
          | torch.where(rand(ny, nx) < 0.05, i32(pixel.REFERENCE_PIXEL), zero))
    lin = LinearityData(coefs, smin, smax, smin + 200.0, dq)
    S = (smin[None] + rand(ngrp, ny, nx) * 5e4 - 2000.0).contiguous()
    attempt = rand(ngrp, ny, nx) < 0.9
    return S, lin, attempt


def med_inputs(ny, nx, N, gen, dev, nan_frac=0.05, edges=False):
    """A noise frame with NaNs and one all-NaN block.  ``edges``: values
    drawn from (-inf, -1, -0.0, +0.0, 1, +inf) instead, so that the
    middle of every block lies among duplicates, signed zeros or
    infinities, and (for N > 1) a block with a single valid value."""
    import torch

    from romanimpreprocess_tpu_torch.ops.sky import block_geometry

    if edges:
        vals = torch.tensor([-float("inf"), -1.0, -0.0, 0.0, 1.0, float("inf")],
                            device=dev)
        arr = vals[torch.randint(0, 6, (ny, nx), generator=gen, device=dev)]
    else:
        arr = torch.randn((ny, nx), generator=gen, device=dev) * 100.0
    arr[torch.rand((ny, nx), generator=gen, device=dev) < nan_frac] = float("nan")
    ky, kx, py, px = block_geometry(ny, nx, N)
    arr[py : py + ky, px : px + kx] = float("nan")  # one all-NaN block
    if edges and N > 1:
        arr[py : py + ky, px + kx : px + 2 * kx] = float("nan")
        arr[py + ky // 2, px + kx + kx // 2] = -0.0  # one valid value
    return arr


def check_lin(shape, gen, dev, timed, card):
    import torch

    from romanimpreprocess_tpu_torch.ops import linearity, linearity_cuda

    S, lin, att = lin_inputs(shape, 4, gen, dev)
    res = {"shape": list(shape)}
    for dnff in (True, False):
        got, dq_got = linearity_cuda.apply_linearity_cube_fused(S, lin, att, dnff)
        ref, dq_ref = linearity.apply_linearity_cube(S, lin, dnff, att)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        # the kernel repeats the plain version's rounded steps (no FMA
        # contraction): DQ must be identical, phi equal to 1e-6 of scale
        require(torch.equal(dq_got, dq_ref), f"linearity {shape}: DQ differs")
        require(err <= 1e-6 * scale, f"linearity {shape}: phi err {err}")
        res[f"max_abs_err_dnff{int(dnff)}"] = err
        res["bit_exact_phi" if dnff else "bit_exact_phi_dnff0"] = bool(
            torch.equal(got, ref))
    res["max_abs_err"] = max(res["max_abs_err_dnff1"], res["max_abs_err_dnff0"])
    if timed:
        ngrp, ny, nx = shape
        res["ms"] = cuda_ms(lambda: linearity_cuda.apply_linearity_cube_fused(
            S, lin, att, True))
        res["plain_ms"] = cuda_ms(lambda: linearity.apply_linearity_cube(
            S, lin, True, att))
        res["library_ms"] = None  # no single PyTorch call computes it
        res["bound_ms"], res["bound_by"] = bound(
            linearity_cuda.bytes_moved(ngrp, ny, nx, 4),
            ngrp * ny * nx * 34, card)
    return res


def check_ipc(ngrp, nside, gen, dev, timed, card, nb=NB, nonfinite=False):
    """The frame inverse (the IPC kernel in the Neumann order) against
    its twin, bit for bit, on ``time_frame.inputs`` (``nonfinite``: a
    NaN and infinities in the outermost border rows and columns it
    reads, which reach the output through their zero weights in both)."""
    import torch

    from romanimpreprocess_tpu_torch.ops import ipc_cuda
    from romanimpreprocess_tpu_torch.utils.time_frame import inputs, same_bits

    data, planes, gain = inputs(ngrp, nside, nb, gen, nonfinite)
    na = nside - 2 * nb
    got = ipc_cuda.ipc_rev2_frame(data, planes, gain, nborder=nb)
    ref = ipc_cuda.ipc_rev2_frame_plain(data, planes, gain, nborder=nb)
    torch.cuda.synchronize()
    what = f"ipc {ngrp}x{nside} nborder {nb} nonfinite={nonfinite}"
    border = torch.ones((nside, nside), dtype=torch.bool, device=dev)
    border[nb : nside - nb, nb : nside - nb] = False
    require(same_bits(got[:, border], data[:, border]),
            f"{what}: border not passed through")
    fin = torch.isfinite(ref)
    err = (got - ref)[fin].abs().max().item()
    scale = ref[fin].abs().max().item()
    # the kernel repeats the plain version's rounded steps in its order
    require(same_bits(got, ref), f"{what}: not bit-identical to the twin "
            f"(max err {err} of {scale})")
    require(bool(fin.all()) != nonfinite, f"{what}: non-finite values")
    res = {"shape": [ngrp, nside, nside], "nborder": nb, "nonfinite": nonfinite,
           "max_abs_err": err, "bit_exact": True}
    if timed:
        res["ms"] = cuda_ms(lambda: ipc_cuda.ipc_rev2_frame(data, planes, gain, nb))
        res["plain_ms"] = cuda_ms(lambda: ipc_cuda.ipc_rev2_frame_plain(
            data, planes, gain, nb))
        res["library_ms"] = None  # no single PyTorch call computes it
        res["bound_ms"], res["bound_by"] = bound(
            ipc_cuda.bytes_moved(ngrp, nside), ngrp * na * na * 42, card)
    return res


def check_ipc_rows(ngrp, nside, n, gen, dev, timed, card, nb=NB, nonfinite=False):
    """The frame inverse on row slabs (``ipc_cuda.ipc_rev2_rows``, the
    launch with a row count of its own) on the ``n`` slabs of
    ``utils.rows.split_rows`` with the least halo it reads
    (``time_frame.check_rows``): the slabs bit for bit to their twins
    and, together, to the kernel's output on the whole frame."""
    from romanimpreprocess_tpu_torch.ops import ipc_cuda
    from romanimpreprocess_tpu_torch.utils.time_frame import check_rows, inputs, slabs

    res = check_rows(ngrp, nside, nb, n, gen, nonfinite)
    require(res["bit_exact"], f"ipc rows {ngrp}x{nside} in {n} slabs nborder {nb} "
            f"nonfinite={nonfinite}: not bit-identical to the twins and the frame form")
    if timed:
        parts = slabs(*inputs(ngrp, nside, nb, gen), n)
        res["ms"] = cuda_ms(lambda: [ipc_cuda.ipc_rev2_rows(d, p, g, nb, *r)
                                     for d, p, g, *r in parts])
        res["plain_ms"] = cuda_ms(lambda: [ipc_cuda.ipc_rev2_rows_plain(d, p, g, nb, *r)
                                           for d, p, g, *r in parts], runs=3, warmup=1)
        res["library_ms"] = None  # no single PyTorch call computes it
        nbytes = sum(ipc_cuda.rows_bytes_moved(ngrp, d.shape[1], nside, lo, hi)
                     for d, _, _, _, lo, hi in parts)
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, ngrp * (nside - 2 * nb) ** 2 * 42, card)
    return res


def check_slab_rows(ngrp, nside, n, gen, dev, timed, card, nb=NB, padded=True, th=32):
    """The slab routes on row slabs (``ipc_slab.correct_cube_fused`` /
    ``correct_cube_stream`` with ``row0, lo, hi``: the slab kernel
    launched with a row count of its own) on the ``n`` slabs of
    ``utils.rows.split_rows``: each slab bit for bit to its twin
    (``correct_cube_plain``), the slabs together bit for bit to
    ``correct_cube_fused`` on the whole frame."""
    import torch

    from romanimpreprocess_tpu_torch.ops import ipc_cuda, ipc_slab
    from romanimpreprocess_tpu_torch.utils.rows import Rows
    from romanimpreprocess_tpu_torch.utils.time_frame import inputs, same_bits, slabs

    data, planes, gain = inputs(ngrp, nside, nb, gen)
    na = nside - 2 * nb
    act = slice(nb, nside - nb)
    K = planes[:, act, act].reshape(3, 3, na, na).contiguous()
    kern = (torch.from_numpy(ipc_slab.kernel_planes_padded(K.cpu().numpy(), th=th))
            .to(dev) if padded else K)
    whole = ipc_slab.correct_cube_fused(data, kern, gain[act, act], nb, th)
    parts = [(d, g[Rows(r0, d.shape[1], lo, hi).active(nside, nb), act], r0, lo, hi)
             for d, _, g, r0, lo, hi in slabs(data, planes, gain, n)]
    del data, planes, gain, K
    calls = {name: [lambda p=p, fn=fn: fn(p[0], kern, p[1], nb, th, *p[2:]) for p in parts]
             for name, fn in (("fused", ipc_slab.correct_cube_fused),
                              ("stream", ipc_slab.correct_cube_stream))}
    twins = [lambda p=p: ipc_slab.correct_cube_plain(p[0], kern, p[1], nb, th, *p[2:])
             for p in parts]
    got = {name: [fn() for fn in fns] for name, fns in calls.items()}
    torch.cuda.synchronize()
    what = f"slab rows {ngrp}x{nside} in {n} slabs nborder {nb} padded={padded}"
    err = 0.0
    for i, fn in enumerate(twins):
        ref = fn()
        for name in got:
            err = max(err, (got[name][i] - ref).abs().max().item())
            require(same_bits(got[name][i], ref),
                    f"{what}: {name} slab {i} not bit-identical to its twin")
    for name in got:
        require(same_bits(torch.cat(got[name], dim=1), whole),
                f"{what}: {name} slabs differ from correct_cube_fused on the frame")
    res = {"shape": [ngrp, nside, nside], "slabs": n, "nborder": nb, "padded": padded,
           "max_abs_err": err, "bit_exact": True, "frame_form_bit_exact": True}
    if timed:
        res["ms"] = cuda_ms(lambda: [fn() for fn in calls["fused"]])
        res["ms_stream"] = cuda_ms(lambda: [fn() for fn in calls["stream"]])
        res["plain_ms"] = cuda_ms(lambda: [fn() for fn in twins], runs=3, warmup=1)
        res["library_ms"] = None  # the weights vary per pixel
        nbytes = sum(ipc_cuda.rows_bytes_moved(ngrp, p[0].shape[1], nside, p[3], p[4])
                     for p in parts)
        res["bound_ms"], res["bound_by"] = bound(nbytes, ngrp * na * na * 42, card)
    return res


def check_med(ny, nx, N, gen, dev, timed, card, path=None, edges=False):
    """``path``: the size branch (``median_cuda.plan``) this case must
    take, as (kernel, CTAs per block)."""
    import torch

    from romanimpreprocess_tpu_torch.ops import median_cuda, sky

    plan = median_cuda.plan(ny, nx, N)
    require(path is None or plan[:2] == path,
            f"blockmed {ny}x{nx}/{N}: plan {plan}, expected {path}")
    arr = med_inputs(ny, nx, N, gen, dev, edges=edges)
    got = median_cuda.block_nanmedian_fused(arr, N)
    ref = sky.block_nanmedian(arr, N)
    torch.cuda.synchronize()
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    require(bool(same.all()), f"blockmed {ny}x{nx}/{N}: not bit-identical")
    # the oracle: numpy's nanmedian on the same blocks
    ky, kx, py, px = sky.block_geometry(ny, nx, N)
    a = arr.cpu().numpy()[py : py + N * ky, px : px + N * kx]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        oracle = np.nanmedian(a.reshape(N, ky, N, kx), axis=(1, 3))
    g = got.cpu().numpy()
    require(bool(((g == oracle) | (np.isnan(g) & np.isnan(oracle))).all()),
            f"blockmed {ny}x{nx}/{N}: differs from np.nanmedian")
    res = {"shape": [ny, nx], "N": N, "path": list(plan), "edges": edges,
           "max_abs_err": 0.0, "bit_exact": True}
    if timed:
        # a row-strided view, as the main path passes the active region
        frame = torch.zeros((ny + 2 * NB, nx + 2 * NB), device=dev)
        frame[NB:-NB, NB:-NB] = arr
        view = frame[NB:-NB, NB:-NB]
        require(bool(((median_cuda.block_nanmedian_fused(view, N) == ref)
                      | torch.isnan(ref)).all()), "blockmed: strided view differs")
        res["ms"] = cuda_ms(lambda: median_cuda.block_nanmedian_fused(view, N))
        res["plain_ms"] = cuda_ms(lambda: sky.block_nanmedian(view, N))
        blocks = (arr[py : py + N * ky, px : px + N * kx]
                  .reshape(N, ky, N, kx).permute(0, 2, 1, 3)
                  .reshape(N * N, ky * kx).contiguous())
        lib = torch.nanquantile(blocks, 0.5, dim=-1).reshape(N, N)
        require(bool(((lib == ref) | torch.isnan(ref)).all()),
                "torch.nanquantile disagrees with the block median")
        res["library_ms"] = cuda_ms(
            lambda: torch.nanquantile(blocks, 0.5, dim=-1))
        res["library_call"] = "torch.nanquantile(blocks, 0.5, dim=-1) on the (N*N, ky*kx) copy"
        res["bound_ms"], res["bound_by"] = bound(
            median_cuda.bytes_moved(ny, nx, N), 64 * N * ky * N * kx, card)
        # a nearly constant frame, as a sky frame is: the keys share their
        # leading digits, so the selection's early rounds keep every key
        flat = 1000.0 + torch.randn((ny, nx), generator=gen, device=dev)
        require(torch.equal(median_cuda.block_nanmedian_fused(flat, N),
                            sky.block_nanmedian(flat, N)),
                "blockmed: nearly constant frame differs")
        res["ms_nearly_constant"] = cuda_ms(
            lambda: median_cuda.block_nanmedian_fused(flat, N))
    return res


def sim_t_matrix(read_pattern, dev):
    import torch

    from romanimpreprocess_tpu_torch.pipeline import sim_to_l1

    return torch.from_numpy(sim_to_l1.contraction_matrix(read_pattern)).to(dev)


def check_contract(T, ny, nx, gen, dev, timed, card):
    import torch

    from romanimpreprocess_tpu_torch.ops import contract_cuda

    ngrp, nreads = T.shape
    # Poisson-like increments: non-negative integers as float32
    x = torch.floor(torch.rand((nreads, ny, nx), generator=gen, device=dev) * 40.0)
    got = contract_cuda.contract_reads(T, x)
    ref = contract_cuda.contract_reads_plain(T, x)
    lib = torch.einsum("jr,ryx->jyx", T, x)
    torch.cuda.synchronize()
    # the kernel repeats the twin's ordered, rounded products and adds
    require(torch.equal(got, ref), f"contract {tuple(x.shape)}: not bit-identical")
    scale = ref.abs().max().item()
    require((lib - ref).abs().max().item() <= 1e-5 * scale,
            f"contract {tuple(x.shape)}: einsum disagrees")
    res = {"shape": [nreads, ny, nx], "ngrp": ngrp, "bit_exact": True,
           "max_abs_err": (got - ref).abs().max().item()}
    if timed:
        res["ms"] = cuda_ms(lambda: contract_cuda.contract_reads(T, x))
        res["plain_ms"] = cuda_ms(lambda: contract_cuda.contract_reads_plain(T, x),
                                  runs=5, warmup=1)
        res["library_ms"] = cuda_ms(lambda: torch.einsum("jr,ryx->jyx", T, x))
        res["library_call"] = 'torch.einsum("jr,ryx->jyx", T, x)'
        res["bound_ms"], res["bound_by"] = bound(
            contract_cuda.bytes_moved(ngrp, nreads, ny, nx),
            2 * ngrp * nreads * ny * nx, card)
    return res


def check_ipc_fwd(ngrp, na, gen, dev, timed, card):
    import torch

    from romanimpreprocess_tpu_torch.ops import ipc, ipc_cuda

    kernel = torch.rand((3, 3, na, na), generator=gen, device=dev) * 0.02
    kernel[1, 1] = 1.0 - (kernel.sum(dim=(0, 1)) - kernel[1, 1])
    cube = torch.rand((ngrp, na, na), generator=gen, device=dev) * 5e4
    gain = 1.4 + 0.2 * torch.rand((na, na), generator=gen, device=dev)
    res = {"shape": [ngrp, na, na]}
    err = 0.0
    for g in (None, gain):
        got = ipc_cuda.ipc_fwd_cube(cube, kernel, g)
        ref = ipc.ipc_fwd(cube, kernel, g)
        torch.cuda.synchronize()
        # same rounded steps in the same order: bit-identical
        require(torch.equal(got, ref),
                f"ipc_fwd {na} gain={g is not None}: not bit-identical "
                f"(max err {(got - ref).abs().max().item()})")
        err = max(err, (got - ref).abs().max().item())
    res["max_abs_err"] = err
    res["bit_exact"] = True
    if timed:
        res["ms"] = cuda_ms(lambda: ipc_cuda.ipc_fwd_cube(cube, kernel))
        res["ms_with_gain"] = cuda_ms(lambda: ipc_cuda.ipc_fwd_cube(cube, kernel, gain))
        res["plain_ms"] = cuda_ms(lambda: ipc.ipc_fwd(cube, kernel), runs=5, warmup=1)
        res["library_ms"] = None  # per-pixel weights: no single PyTorch call
        res["bound_ms"], res["bound_by"] = bound(
            ipc_cuda.fwd_bytes_moved(ngrp, na), ngrp * na * na * 17, card)
    return res


def check_invlin(ngrp, nside, nb, ncoef, gen, dev, timed, card):
    """Kernel D against ``(x / gain)`` -> ``linearity.invert_linearity``
    on the active window, S and exflag bit for bit: full-frame cal planes
    (smin about 5000, smax 56000-66000, the linear term their half span,
    small higher orders), x from below the range to above it so that z
    reaches both domain edges."""
    import torch

    from romanimpreprocess_tpu_torch.ops import invlin_cuda, linearity

    def rand(*s):
        return torch.rand(s, generator=gen, device=dev)

    na = nside - 2 * nb
    act = slice(nb, nside - nb)
    smin = 4500.0 + 1000.0 * rand(nside, nside)
    smax = 56000.0 + 10000.0 * rand(nside, nside)
    coefs = (rand(ncoef, nside, nside) - 0.5) * 10.0
    coefs[0] = 0.5 * (smax - smin) - 300.0
    if ncoef > 1:
        coefs[1] = 0.5 * (smax - smin)
    gain = 1.4 + 0.2 * rand(nside, nside)
    lin = linearity.LinearityData(coefs.contiguous(), smin, smax, smin + 300.0,
                                  torch.zeros((nside, nside), dtype=torch.int32,
                                              device=dev))
    lin_act = linearity.LinearityData(*(a[..., act, act] for a in lin))
    x = (rand(ngrp, na, na) * 73000.0 - 3000.0) * gain[act, act]

    def plain():
        return linearity.invert_linearity(x / gain[act, act], lin_act)

    got, ex_got = invlin_cuda.invert_linearity_fused(x, gain, lin)
    ref, ex_ref = plain()
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    require(torch.equal(got, ref) and torch.equal(ex_got, ex_ref),
            f"invert_linearity {ngrp}x{na}^2, {ncoef} coefficients: not bit-identical "
            f"(max err {err})")
    z = (got - lin_act.smin) / (lin_act.smax - lin_act.smin) * 2 - 1
    require(z.min().item() < -1 + 1e-5 and z.max().item() > 1 - 1e-5,
            f"invert_linearity {ngrp}x{na}^2: z did not reach both domain edges")
    res = {"shape": [ngrp, na, na], "ncoef": ncoef, "max_abs_err": err, "bit_exact": True}
    if timed:
        res["ms"] = cuda_ms(lambda: invlin_cuda.invert_linearity_fused(x, gain, lin))
        res["plain_ms"] = cuda_ms(plain, runs=3, warmup=1)
        res["library_ms"] = None  # no single PyTorch call computes it
        # no FMA: each operation is one instruction, half the F32 peak
        res["bound_ms"], res["bound_by"] = bound(
            invlin_cuda.bytes_moved(ngrp, na, ncoef), invlin_cuda.flops(ngrp, na, ncoef),
            card, ops_rate=F32_RATE / 2)
    return res


def check_ipc_slab(ngrp, na, gen, dev, timed, card, with_gain=True, padded=True,
                   th=32):
    """The slab-layout IPC inverse's entry points on one input: the
    blocked and the streaming form on the (ngrp, na, na) active cube,
    the fused form and the streaming route's frame form on the (ngrp,
    na + 2 NB, na + 2 NB) frame; one kernel serves them all (its plan:
    ``ipc_slab.plan``).  It repeats the twin's rounded steps in its
    order, so every comparison is bit for bit: each against the twin,
    blocked against streaming, each frame's active region against the
    cube form and its border against the input, and a second launch
    against the first."""
    import torch

    from romanimpreprocess_tpu_torch.ops import ipc_slab

    nside = na + 2 * NB
    K = torch.rand((3, 3, na, na), generator=gen, device=dev) * 0.02
    K[1, 1] = 1.0 - (K.sum(dim=(0, 1)) - K[1, 1])
    data = torch.rand((ngrp, nside, nside), generator=gen, device=dev) * 1000.0
    gain_frame = 1.4 + 0.2 * torch.rand((nside, nside), generator=gen, device=dev)
    # the active view of the full-frame gain, as the main path passes it
    gain = gain_frame[NB : nside - NB, NB : nside - NB] if with_gain else None
    kern = K
    if padded:
        kern = torch.from_numpy(
            ipc_slab.kernel_planes_padded(K.cpu().numpy(), th=th)).to(dev)
    cube = data[:, NB : nside - NB, NB : nside - NB].contiguous()
    what = f"ipc_slab {ngrp}x{na} gain={with_gain} padded={padded}"

    calls = {
        "ipc_rev2_cube_blocked": lambda: ipc_slab.ipc_rev2_cube_blocked(
            cube, kern, gain, th=th),
        "ipc_rev2_cube_stream": lambda: ipc_slab.ipc_rev2_cube_stream(
            cube, kern, gain, th=th),
        "correct_cube_fused": lambda: ipc_slab.correct_cube_fused(
            data, kern, gain, nborder=NB, th=th),
        # the pallas-stream route's frame form (kernel 5 on the frame)
        "correct_cube_stream": lambda: ipc_slab.correct_cube_stream(
            data, kern, gain, nborder=NB, th=th),
    }
    twins = {
        "ipc_rev2_cube_blocked": lambda: ipc_slab.ipc_rev2_plain(
            cube, K.reshape(9, na, na), gain),
        "correct_cube_fused": lambda: ipc_slab.correct_cube_plain(
            data, kern, gain, nborder=NB, th=th),
    }
    twins["ipc_rev2_cube_stream"] = twins["ipc_rev2_cube_blocked"]
    twins["correct_cube_stream"] = twins["correct_cube_fused"]
    got = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    res = {}
    for k, fn in twins.items():
        ref = fn()
        err = (got[k] - ref).abs().max().item()
        require(torch.equal(got[k], ref), f"{what}: {k} not bit-identical to its "
                f"twin (max err {err})")
        require(torch.equal(calls[k](), got[k]), f"{what}: two launches of {k} differ")
        res[k] = {"shape": list(got[k].shape), "gain": with_gain, "padded": padded,
                  "max_abs_err": err, "bit_exact": True}
        del ref
    blocked, fused = got["ipc_rev2_cube_blocked"], got["correct_cube_fused"]
    require(torch.equal(blocked, got["ipc_rev2_cube_stream"]),
            f"{what}: blocked and streaming entry points differ")
    border = torch.ones((nside, nside), dtype=torch.bool, device=dev)
    border[NB : nside - NB, NB : nside - NB] = False
    for k in ("correct_cube_fused", "correct_cube_stream"):
        require(torch.equal(got[k][:, NB : nside - NB, NB : nside - NB], blocked),
                f"{what}: {k} active region differs from the cube form")
        require(torch.equal(got[k][:, border], data[:, border]),
                f"{what}: {k} border not passed through")
    del got, blocked, fused
    if timed:
        frame_bytes = ipc_slab.fused_bytes_moved(ngrp, nside, NB, with_gain)
        nbytes = {
            "ipc_rev2_cube_blocked": ipc_slab.bytes_moved(ngrp, na, with_gain),
            "ipc_rev2_cube_stream": ipc_slab.bytes_moved(ngrp, na, with_gain),
            "correct_cube_fused": frame_bytes, "correct_cube_stream": frame_bytes,
        }
        for k in calls:
            res[k]["ms"] = cuda_ms(calls[k])
            res[k]["plain_ms"] = cuda_ms(twins[k], runs=3, warmup=1)
            # the weights vary per pixel: no single PyTorch call computes it
            res[k]["library_ms"] = None
            res[k]["bound_ms"], res[k]["bound_by"] = bound(
                nbytes[k], ngrp * na * na * 42, card)
    return res


#: the pink kernel against its plain version, as shares of the frames'
#: standard deviation: the JAX package's gate for its Pallas kernel
#: against its XLA path (same cast points, another order of sums)
PINK_GATE_STD = 1e-2
PINK_GATE_MAX = 5e-2


def check_pink(ntr, length, gen, dev, timed, card, wgmma=True):
    """``wgmma``: the size branch (``pink_cuda.uses_wgmma``) this length
    must take."""
    import torch

    from romanimpreprocess_tpu_torch.ops import pink, pink_cuda

    require(pink_cuda.uses_wgmma(*pink.split_length(length)) == wgmma,
            f"pink {length}: expected the {'wgmma' if wgmma else 'mma.sync'} path")
    white = torch.randn((ntr, 2, length), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    got = pink_cuda.pink_from_white(white)
    torch.cuda.synchronize()
    ref = pink.pink_from_white_plain(white)
    require(got.shape == ref.shape == (2 * ntr, length // 2), "pink: shape")
    require(bool(torch.isfinite(got).all()), "pink: not finite")
    s = ref.std().item()
    d = (got - ref).abs()
    dstd, dmax = d.std().item() / s, d.max().item() / s
    require(dstd < PINK_GATE_STD and dmax < PINK_GATE_MAX,
            f"pink {ntr}x{length}: diff std {dstd}, max {dmax} of the frame std")
    mean = got.mean(dim=-1).abs().max().item()
    require(mean < 1e-3 * s, f"pink {ntr}x{length}: frame mean {mean}")
    again = pink_cuda.pink_from_white(white)
    require(torch.equal(again, got), "pink: two launches on one input differ")
    res = {"shape": [ntr, 2, length], "path": "wgmma" if wgmma else "mma.sync",
           "max_abs_err": d.max().item(),
           "frame_std": s, "diff_std_over_std": dstd, "diff_max_over_std": dmax,
           "max_abs_frame_mean": mean}
    del ref, d, again
    if timed:
        # the f32 transform of the same shaped spectrum by cuFFT: first
        # half, Re and Im, mean removed (not the bf16 transform)
        amp = pink.amplitude(length, dev)
        spec = torch.complex((white[:, 0] * amp).float(), (white[:, 1] * amp).float())

        def library():
            x = torch.fft.fft(spec, dim=-1)[:, : length // 2]
            blk = torch.cat([x.real, x.imag], dim=0)
            return blk - blk.mean(dim=-1, keepdim=True)

        lib = library()
        dl = (got - lib).abs()
        res["vs_f32_fft_diff_std_over_std"] = dl.std().item() / s
        res["vs_f32_fft_diff_max_over_std"] = dl.max().item() / s
        del lib, dl
        res["ms"] = cuda_ms(lambda: pink_cuda.pink_from_white(white))
        res["plain_ms"] = cuda_ms(lambda: pink.pink_from_white_plain(white),
                                  runs=3, warmup=1)
        res["library_ms"] = cuda_ms(library, runs=5, warmup=1)
        res["library_call"] = ("torch.fft.fft of the shaped complex64 spectrum, "
                               "first half, Re and Im, mean removed (f32, not bf16)")
        res["bound_ms"], res["bound_by"] = bound(
            pink_cuda.bytes_moved(ntr, length), pink_cuda.flops(ntr, length),
            card, ops_rate=BF16_RATE)
    return res


KERNELS = {
    "linearity": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/linearity.cu",
        replaces="romanimpreprocess_tpu/ops/linearity_pallas.py:70"),
    "ipc_rev2_frame": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/ipc_slab.cu",
        replaces="romanimpreprocess_tpu/ops/ipc_pallas.py:425"),
    "block_nanmedian": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/blockmed.cu",
        replaces="romanimpreprocess_tpu/ops/median_pallas.py:55"),
    "ipc_fwd_cube": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/ipc_fwd.cu",
        replaces="romanimpreprocess_tpu/ops/ipc_pallas.py:285"),
    "pink_frames": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/pink.cu",
        replaces="romanimpreprocess_tpu/ops/pink_pallas.py:73"),
    "contract_reads": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/contract.cu",
        replaces="romanimpreprocess_tpu/ops/contract_pallas.py:36"),
    "ipc_rev2_cube_blocked": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/ipc_slab.cu",
        replaces="romanimpreprocess_tpu/ops/ipc_pallas.py:141"),
    "ipc_rev2_cube_stream": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/ipc_slab.cu",
        replaces="romanimpreprocess_tpu/ops/ipc_pallas.py:221"),
    "correct_cube_fused": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/ipc_slab.cu",
        replaces="romanimpreprocess_tpu/ops/ipc_pallas.py:335"),
    # kernel D: no Pallas kernel; XLA fuses the JAX package's loop
    "invert_linearity": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/invlin.cu",
        replaces="none (XLA-fused romanimpreprocess_tpu/ops/linearity.py:107)"),
}
SLAB_KERNELS = ("ipc_rev2_cube_blocked", "ipc_rev2_cube_stream", "correct_cube_fused")


def kernel_counters():
    """(module, counter attribute) of every kernel in :data:`KERNELS`."""
    from romanimpreprocess_tpu_torch.ops import (contract_cuda, invlin_cuda, ipc_cuda,
                                                 ipc_slab, linearity_cuda, median_cuda,
                                                 pink_cuda)

    return {"linearity": (linearity_cuda, "launches"),
            "ipc_rev2_frame": (ipc_cuda, "launches"),
            "block_nanmedian": (median_cuda, "launches"),
            "ipc_fwd_cube": (ipc_cuda, "fwd_launches"),
            "pink_frames": (pink_cuda, "launches"),
            "contract_reads": (contract_cuda, "launches"),
            "ipc_rev2_cube_blocked": (ipc_slab, "blocked_launches"),
            "ipc_rev2_cube_stream": (ipc_slab, "stream_launches"),
            "correct_cube_fused": (ipc_slab, "fused_launches"),
            "invert_linearity": (invlin_cuda, "launches")}


def phase_kernels(card):
    import torch

    from romanimpreprocess_tpu_torch import synth

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20240901)
    rp = synth.READ_PATTERN_DEFAULT
    out = {}
    small = {
        "linearity": [check_lin((NGRP, 128, 128), gen, dev, False, card),
                      check_lin((3, 120, 130), gen, dev, False, card)],
        # group counts above one register chunk (9, 17), a frame
        # narrower than one warp strip (20), nborder 2 and 0, and
        # non-finite values in the border rows and columns read
        "ipc_rev2_frame": [check_ipc(NGRP, 128, gen, dev, False, card),
                           check_ipc(3, 120, gen, dev, False, card, nonfinite=True),
                           check_ipc(9, 131, gen, dev, False, card, nb=2),
                           check_ipc(17, 67, gen, dev, False, card, nonfinite=True),
                           check_ipc(1, 20, gen, dev, False, card),
                           check_ipc(5, 130, gen, dev, False, card, nb=0),
                           check_ipc(6, 1000, gen, dev, False, card, nb=2,
                                     nonfinite=True)],
        # every size branch: clusters of 1, 2, 4 and 8 CTAs and the
        # streaming kernel, on noise and on duplicates / +-0 / +-inf
        "block_nanmedian": [
            check_med(130, 125, 8, gen, dev, False, card, ("cluster", 1)),
            check_med(128, 120, 4, gen, dev, False, card, ("cluster", 1), edges=True),
            check_med(803, 1001, 4, gen, dev, False, card, ("cluster", 2), edges=True),
            check_med(301, 260, 1, gen, dev, False, card, ("cluster", 4)),
            check_med(1022, 1022, 2, gen, dev, False, card, ("cluster", 8), edges=True),
            check_med(400, 400, 128, gen, dev, False, card, ("cluster", 1)),
            check_med(700, 701, 1, gen, dev, False, card, ("stream", 0)),
            check_med(1300, 1310, 2, gen, dev, False, card, ("stream", 0), edges=True)],
        "ipc_fwd_cube": [check_ipc_fwd(NGRP, 120, gen, dev, False, card),
                         check_ipc_fwd(3, 67, gen, dev, False, card)],
        # 2^14: the mma.sync path; 2^16 and 2^17 (n1 != n2): the wgmma path
        "pink_frames": [check_pink(3, 1 << 14, gen, dev, False, card, wgmma=False),
                        check_pink(3, 1 << 16, gen, dev, False, card, wgmma=True),
                        check_pink(2, 1 << 17, gen, dev, False, card, wgmma=True)],
        "contract_reads": [
            check_contract(sim_t_matrix(rp, dev), 120, 120, gen, dev, False, card),
            check_contract(torch.rand((11, 5), generator=gen, device=dev),
                           37, 53, gen, dev, False, card)],
        # every coefficient count the lane and the synthetic packs use,
        # one group, a frame that is not a multiple of a block
        "invert_linearity": [check_invlin(8, 520, 4, 7, gen, dev, False, card),
                             check_invlin(1, 256, 0, 4, gen, dev, False, card),
                             check_invlin(3, 131, 2, 1, gen, dev, False, card)],
    }
    # group counts above one register chunk (9, 17), a frame narrower
    # than one warp strip (20), sizes that are multiples of neither the
    # strip nor the segment (67, 131, 1000); gain on and off, raw and
    # pre-padded planes
    slab_small = [
        check_ipc_slab(3, 96, gen, dev, False, card, True, True, th=16),
        check_ipc_slab(2, 100, gen, dev, False, card, False, False, th=16),
        check_ipc_slab(1, 100, gen, dev, False, card, True, False, th=8),
        check_ipc_slab(1, 131, gen, dev, False, card, False, True, th=32),
        check_ipc_slab(9, 67, gen, dev, False, card, True, True, th=32),
        check_ipc_slab(17, 131, gen, dev, False, card, False, False, th=8),
        check_ipc_slab(2, 20, gen, dev, False, card, True, False, th=8),
        check_ipc_slab(6, 1000, gen, dev, False, card, True, True, th=32),
        check_ipc_slab(9, 1000, gen, dev, False, card, False, True, th=16),
    ]
    for k in SLAB_KERNELS:
        small[k] = [r[k] for r in slab_small]
    # the frame inverse's row-slab form: 2 to 5 slabs, a frame narrower
    # than one warp strip, nborder 2 and 0, non-finite border values
    small["ipc_rev2_rows"] = [
        check_ipc_rows(NGRP, 128, 2, gen, dev, False, card),
        check_ipc_rows(3, 120, 3, gen, dev, False, card, nonfinite=True),
        check_ipc_rows(9, 131, 5, gen, dev, False, card, nb=2, nonfinite=True),
        check_ipc_rows(1, 20, 2, gen, dev, False, card),
        check_ipc_rows(5, 130, 4, gen, dev, False, card, nb=0)]
    # the slab routes' row form: raw and pre-padded planes, nborder 2
    small["correct_rows"] = [
        check_slab_rows(3, 96, 2, gen, dev, False, card, th=16),
        check_slab_rows(9, 131, 5, gen, dev, False, card, padded=False, th=8),
        check_slab_rows(17, 67, 3, gen, dev, False, card, nb=2, padded=False, th=8),
        check_slab_rows(1, 20, 2, gen, dev, False, card, th=8)]
    emit({"phase": "kernels_small", "ok": True, "results": small})
    na = NSIDE - 2 * NB
    out["linearity"] = check_lin((NGRP, NSIDE, NSIDE), gen, dev, True, card)
    torch.cuda.empty_cache()
    out["ipc_rev2_frame"] = check_ipc(NGRP, NSIDE, gen, dev, True, card)
    torch.cuda.empty_cache()
    # the row-slab form as the spatial phase's two-entry mesh cuts the frame
    out["ipc_rev2_rows"] = check_ipc_rows(NGRP, NSIDE, 2, gen, dev, True, card)
    torch.cuda.empty_cache()
    out["correct_rows"] = check_slab_rows(NGRP, NSIDE, 2, gen, dev, True, card)
    torch.cuda.empty_cache()
    out["block_nanmedian"] = check_med(na, na, 8, gen, dev, True, card)
    torch.cuda.empty_cache()
    out["ipc_fwd_cube"] = check_ipc_fwd(NGRP, na, gen, dev, True, card)
    torch.cuda.empty_cache()
    # the fill's frames at 4096^2: 6 groups x (1 common + 32 channels +
    # amp33) = 204 frames = 102 transforms of length 2 * 4096 * 128
    out["pink_frames"] = check_pink(NGRP * 34 // 2, 2 * NSIDE * (NSIDE // 32),
                                    gen, dev, True, card)
    torch.cuda.empty_cache()
    out["contract_reads"] = check_contract(sim_t_matrix(rp, dev), na, na, gen, dev,
                                           True, card)
    torch.cuda.empty_cache()
    # the production lane's shape: 8 groups of 4088^2, Legendre order 6
    out["invert_linearity"] = check_invlin(8, NSIDE, NB, 7, gen, dev, True, card)
    torch.cuda.empty_cache()
    # as the main path calls them: gain, the pre-padded planes at th=32
    out.update(check_ipc_slab(NGRP, na, gen, dev, True, card, True, True, th=32))
    torch.cuda.empty_cache()
    emit({"phase": "kernels_full", "ok": True, "card": card, "results": out})
    return out


# --------------------------------------------------------------------------
# Phase 3: the plain path on the card against the plain path on the CPU
# --------------------------------------------------------------------------

def phase_plain_devices(card):
    """The port's plain path on ``cuda`` held to the same path on
    ``cpu`` at 128^2 (``parity.plain_devices``): the classic fit and the
    likelihood fit (slab twin) at the slice's gates, the sim at its
    moment and envelope gates.  The card's checks hold its kernels to
    its plain path; this holds that path to the CPU's, which the CPU
    tests hold to the JAX package."""
    import torch

    from romanimpreprocess_tpu_torch.utils import parity

    d = tempfile.mkdtemp(prefix="chip_smoke_devices_")
    t0 = time.perf_counter()
    try:
        rep = parity.plain_devices(d, "cpu", torch.device("cuda"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    # reported, not gated: per output, the share of values whose bits
    # differ between the card's plain path and the CPU's, and the
    # largest difference in ulps and in value
    emit({"phase": "plain_devices_bits", "card": card, "nside": 128, **rep.pop("bits")})
    emit({"phase": "plain_devices", "ok": True, "card": card, "nside": 128,
          "seconds": time.perf_counter() - t0, **rep})


# --------------------------------------------------------------------------
# Phase 4: the main path
# --------------------------------------------------------------------------

#: the L2 tree's float maps held by :func:`_compare_l2`
L2_MAPS = ("data", "data_withsky", "err", "var_poisson", "var_rnoise")


def _l2_outputs(tree):
    """The fields of an L2 tree that :func:`_compare_l2` holds, under the
    names ``parity.compare_outputs`` reads (``pdq``: the active ``dq``)."""
    im, pi = tree["roman"], tree["processinfo"]
    out = {k: np.asarray(im[k]) for k in L2_MAPS}
    out.update(pdq=np.asarray(im["dq"]), skycoefs=np.asarray(pi["skycoefs"]),
               medsky=np.asarray(pi["medsky"]), endslice=np.asarray(pi["endslice"]))
    return out


def _compare_l2(ref, got, what, loose_bits=4, sky="rtol", atol_frac=1e-5,
                outside_frac=0.0):
    """Two L2 trees at the slice's parity gates (``parity.compare_outputs``):
    DQ bit-exact except ``loose_bits`` (JUMP_DET; with the likelihood fit
    also DO_NOT_USE, which a jump too early to refit sets) on at most 1e-4
    of pixels; the maps within rtol 1e-5 and atol ``atol_frac`` max|ref|
    (1e-5 between two paths that round alike) on all but ``outside_frac``
    of the pixels; ``skycoefs`` and ``medsky`` within rtol 1e-4, or with
    ``sky="derived"`` within the bound the measured difference of
    ``data_withsky`` puts on them (``parity.sky_bounds``); endslice
    exact."""
    from romanimpreprocess_tpu_torch.utils import parity

    return parity.compare_outputs(
        _l2_outputs(ref), _l2_outputs(got), what, maps=L2_MAPS, loose_bits=loose_bits,
        atol_frac=atol_frac, outside_frac=outside_frac, sky=sky)


def make_caldir(d, nside):
    """The synthetic CALDIR (the port's synth) both main paths use."""
    from romanimpreprocess_tpu_torch import synth

    return synth.make_cal_files(d + "/roman_wfi", synth.READ_PATTERN_DEFAULT,
                                nside=nside, seed=5,
                                channelwidth=max(nside // 32, 4))


def make_inputs(d, nside, rate_dn_s=10.0, sources_dn_s=0.0, name="L1"):
    """Synthetic L1 (the port's synth) ``<name>.asdf`` in directory ``d``
    for the CALDIR of :func:`make_caldir`; returns (L1 path, injected
    rate map).  ``sources_dn_s``: that much more rate on 10% of the
    active pixels (seed 8), so that the brightest 5% are sources."""
    from romanimpreprocess_tpu_torch import synth

    rp = synth.READ_PATTERN_DEFAULT
    cal = synth.synth_cal_arrays(nside, rp, seed=5)
    data = synth.synth_l1_cube(cal, rp, seed=7, rate_dn_s=rate_dn_s, nborder=NB)
    rate = synth.injected_rate(nside, rate_dn_s, nborder=NB, seed=7)
    if sources_dn_s:
        src = (np.random.RandomState(8).uniform(size=rate.shape) < 0.1) & (rate > 0)
        rate = rate + np.float32(sources_dn_s) * src
        for j, t in enumerate(cal["t"]):
            data[j][src] += np.uint16(round(sources_dn_s * t))
    del cal
    amp33 = synth.synth_amp33(nside, len(rp), max(nside // 32, 4))
    path = f"{d}/{name}.asdf"
    synth.write_l1_file(path, data, rp, amp33=amp33)
    return path, rate


def phase_main(card, device, d, caldir, nside=NSIDE):
    import torch

    from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles
    from romanimpreprocess_tpu_torch.ops import ipc_cuda, linearity_cuda, median_cuda
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2

    mods = {"linearity": linearity_cuda, "ipc_rev2_frame": ipc_cuda,
            "block_nanmedian": median_cuda}
    t0 = time.perf_counter()
    l1path, rate = make_inputs(d, nside)
    t_synth = time.perf_counter() - t0
    base = {"IN": l1path, "CALDIR": caldir, "SKYORDER": 2, "SLICEOUT": True,
            "IPC_BACKEND": "auto", "LIN_BACKEND": "auto", "SKY_BACKEND": "auto"}
    cfg_k = dict(base, OUT=d + "/L2_cuda.asdf")
    cfg_p = dict(base, OUT=d + "/L2_plain.asdf", IPC_BACKEND="xla",
                 LIN_BACKEND="xla", SKY_BACKEND="xla")

    # ---- the main path, counted ----
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    l1_to_l2.calibrateimage(cfg_k, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    launches = {k: m.launches for k, m in mods.items()}

    pack = calfiles.load_caldir_cached(caldir)
    l1 = asdf_lite.open(l1path)["roman"]
    prep = l1_to_l2.prepare_inputs(l1, cfg_k, pack, device=device)
    backends = {k: prep["cfg"][k] for k in ("ipc", "lin", "med")}

    # ---- the L2 product ----
    l2 = asdf_lite.open(cfg_k["OUT"])
    im = l2["roman"]
    na = nside - 2 * NB
    data = np.asarray(im["data"])
    require(data.shape == (na, na), f"L2 data shape {data.shape}")
    require(bool(np.isfinite(data).all()), "L2 data not finite")
    dq = np.asarray(im["dq"])
    require(dq.dtype == np.uint32 and (dq != 0).any(), "L2 dq not populated")
    flat = pack.flat[NB:-NB, NB:-NB]
    good = dq == 0
    ratio = float(np.median((np.asarray(im["data_withsky"]) * flat)[good]
                            / rate[NB:-NB, NB:-NB][good]))
    corr = float(np.corrcoef(np.asarray(im["data_withsky"])[good],
                             rate[NB:-NB, NB:-NB][good])[0, 1])
    require(0.97 < ratio < 1.03, f"slope/rate median ratio {ratio}")
    require(corr > 0.9, f"slope/rate correlation {corr}")

    # ---- the plain path on the same device ----
    l1_to_l2.calibrateimage(cfg_p, device=device)
    parity = _compare_l2(asdf_lite.open(cfg_p["OUT"]), l2, "kernels vs plain")

    res = {"phase": "main_path", "ok": True, "card": card,
           "nside": nside, "ngrp": NGRP, "device": str(device),
           "backends": backends, "launches": launches,
           "synth_s": t_synth, "calibrateimage_s": t_cal,
           "slope_over_rate_median": ratio, "slope_rate_corr": corr,
           "good_frac": float(good.mean()), "parity": parity}

    # ---- the warm core, kernels and plain path in turns ----
    if device.type == "cuda":
        prep_p = l1_to_l2.prepare_inputs(l1, cfg_p, pack, device=device)
        core_k = l1_to_l2.make_core(prep["plan"], prep["cfg"], prep["geom"])
        core_p = l1_to_l2.make_core(prep_p["plan"], prep_p["cfg"], prep_p["geom"])
        tk, tp = [], []
        for _ in range(2):
            tk.append(cuda_ms(lambda: core_k(prep["arr"]), runs=5, warmup=1))
            tp.append(cuda_ms(lambda: core_p(prep_p["arr"]), runs=5, warmup=1))
        res["core_ms_kernels"] = tk
        res["core_ms_plain"] = tp
        res["profile_kernels"] = profile(lambda: core_k(prep["arr"]))
        res["profile_plain"] = profile(lambda: core_p(prep_p["arr"]))
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        ipc_ms = {k: res[k].get("stage_device_ms", {}).get("ipc")
                  for k in ("profile_kernels", "profile_plain")}
        print(f"classic core: ipc stage device time {ipc_ms['profile_kernels']} ms "
              f"with the kernels, {ipc_ms['profile_plain']} ms plain", flush=True)
    emit(res)
    return launches, backends, l1path, rate


# --------------------------------------------------------------------------
# Phase 4b: row-sharded calibration of one SCA
# --------------------------------------------------------------------------

#: the kernel (its counter in :func:`kernel_counters`) of each IPC route
IPC_ROUTE_KERNEL = {"cuda": "ipc_rev2_frame", "slab": "correct_cube_fused",
                    "slab-stream": "ipc_rev2_cube_stream"}


def _spatial_case(prep, mesh, what, timed=False):
    """The row-sharded core on ``mesh`` against the single core on the
    same bundle (``parity.row_shard_gate``), launch counts (one IPC
    launch a slab) and gathered bytes read around the sharded call;
    ``timed``: the warm calls of both, CUDA-event medians of 5."""
    import torch

    from romanimpreprocess_tpu_torch.parallel import spatial
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2
    from romanimpreprocess_tpu_torch.utils import parity, profiling

    plan, cfg, geom = prep["plan"], prep["cfg"], prep["geom"]
    core = l1_to_l2.make_core(plan, cfg, geom)
    ref = core(prep["arr"])
    score = spatial.make_spatial_calibrator(plan, cfg, geom, mesh)
    shards = spatial.shard_rows(mesh, prep["arr"], geom)
    counters = kernel_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    profiling.reset()
    # the recorder's counters count while a profiler records
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = score(shards)
        torch.cuda.synchronize()
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    rows = launches[IPC_ROUTE_KERNEL[cfg["ipc"]]]
    res = {"mesh": [str(d) for d in mesh], "slab_rows": [r.n for r in shards.rows],
           "ipc": cfg["ipc"], "launches": launches, "ipc_rows_launches": rows,
           "gathered_bytes": profiling.snapshot()["counters"].get("gather_bytes", 0)}
    for k in ("linearity", "block_nanmedian", IPC_ROUTE_KERNEL[cfg["ipc"]]):
        require(launches[k] >= 1, f"{what}: kernel {k} not launched")
    require(rows == len(mesh), f"{what}: {rows} row-slab IPC launches for {len(mesh)} slabs")
    full = spatial.gather_rows(out, mesh[0])
    res["drift"] = parity.row_shard_gate(ref, full, what)
    res["equal"] = {k: bool(torch.equal(ref[k], full[k])) for k in ref}
    if timed:
        res["spatial_ms"] = cuda_ms(lambda: score(shards), runs=5, warmup=1)
        res["single_ms"] = cuda_ms(lambda: core(prep["arr"]), runs=5, warmup=1)
    return res


def phase_spatial(card, device, d, caldir, l1path):
    """The main path's CALDIR and L1 through ``prepare_inputs`` (every
    backend ``auto``) and the row-sharded core (``parallel.spatial``) on a
    one-card mesh of two entries: the classic fit (timed, launches read
    around it), the likelihood fit, and the classic fit on three entries
    (uneven slabs), each held to the single core at the JAX package's
    ``tests/test_spatial.py`` gate with the measured drift printed."""
    import torch

    from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles
    from romanimpreprocess_tpu_torch.parallel import spatial
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2

    t0 = time.perf_counter()
    pack = calfiles.load_caldir_cached(caldir)
    l1 = asdf_lite.open(l1path)["roman"]
    base = {"IN": l1path, "CALDIR": caldir, "SKYORDER": 2, "SLICEOUT": True,
            "IPC_BACKEND": "auto", "LIN_BACKEND": "auto", "SKY_BACKEND": "auto"}
    two = spatial.row_mesh(devices=[device, device])
    res = {"phase": "spatial", "ok": True, "card": card, "nside": NSIDE, "ngrp": NGRP}
    prep = l1_to_l2.prepare_inputs(l1, base, pack, device=device)
    require(all(prep["cfg"][k] == "cuda" for k in ("ipc", "lin", "med")),
            "spatial: auto did not resolve to the CUDA kernels")
    res["classic_2"] = _spatial_case(prep, two, "spatial classic, 2 entries", timed=True)
    launches = res["classic_2"]["launches"]
    res["classic_3"] = _spatial_case(prep, spatial.row_mesh(devices=[device] * 3),
                                     "spatial classic, 3 entries")
    del prep
    torch.cuda.empty_cache()
    prep = l1_to_l2.prepare_inputs(l1, dict(base, romancal_ramp_fit=True), pack,
                                   device=device)
    res["likely_2"] = _spatial_case(prep, two, "spatial likelihood, 2 entries")
    del prep
    torch.cuda.empty_cache()
    # the slab IPC routes' row forms (kernels 6 and 5 on the slabs)
    prep = l1_to_l2.prepare_inputs(l1, dict(base, romancal_ramp_fit=True,
                                            IPC_BACKEND="pallas"), pack, device=device)
    res["likely_pallas_2"] = _spatial_case(prep, two, "spatial likelihood, pallas")
    prep["cfg"]["ipc"] = "slab-stream"
    res["likely_pallas_stream_2"] = _spatial_case(
        prep, two, "spatial likelihood, pallas-stream")
    del prep
    torch.cuda.empty_cache()
    slab_launches = {k: res["likely_pallas_2"]["launches"][k]
                     + res["likely_pallas_stream_2"]["launches"][k] for k in launches}
    res["phase_s"] = time.perf_counter() - t0
    c = res["classic_2"]
    for k in ("classic_2", "classic_3", "likely_2", "likely_pallas_2",
              "likely_pallas_stream_2"):
        eq = all(res[k]["equal"].values())
        print(f"spatial {k}: largest drift per output {res[k]['drift']} "
              f"({'equal to the single core' if eq else 'NOT equal to the single core'}"
              f", within the gate)", flush=True)
    print(f"spatial: warm call {c['spatial_ms']:.3f} ms on two entries of one card, "
          f"single core {c['single_ms']:.3f} ms; gathered {c['gathered_bytes']} bytes; "
          f"launches {c['launches']} ({card})", flush=True)
    emit(res)
    return launches, slab_launches


# --------------------------------------------------------------------------
# Phase 5: the noise engine
# --------------------------------------------------------------------------

NOISE_SEED = 15000
#: the kernels the noise path reaches under every backend ``auto`` and
#: ``CONTRACT_BACKEND: pallas``
NOISE_KERNELS = ("linearity", "ipc_rev2_frame", "block_nanmedian", "pink_frames",
                 "contract_reads")


def phase_noise(card, device, d, caldir, nside=NSIDE):
    """The noise engine at full size: ``generate_all_noise`` with the
    example layers, ``device-strict``, every backend ``auto`` and
    ``CONTRACT_BACKEND: pallas``, kernel launches and Pearson type-4
    rejection rounds read around that call; the cube checked (shape,
    finite, the same seed twice gives the same cube), held to the plain
    path's (every backend ``xla`` / ``dot``) at the spread gates, and
    its 'O' layer to the signal; the warm runner timed and profiled; the
    likelihood fit under ``IPC_BACKEND: pallas-stream`` once."""
    import torch

    from romanimpreprocess_tpu_torch.galpoisson import pearson_torch
    from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, noise, noise_core
    from romanimpreprocess_tpu_torch.utils import parity

    counters = kernel_counters()

    def reset():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    # phase_main's sky with sources: on a 5-15 DN/s sky alone the 'O'
    # layer's std ratio, bright 5% to faint 50%, is sqrt(14.75 / 7.5) =
    # 1.4, under the gate's 1.5
    t0 = time.perf_counter()
    l1path, _ = make_inputs(d, nside, sources_dn_s=100.0, name="L1_noise")
    t_synth = time.perf_counter() - t0
    layers = list(parity.NOISE_LAYERS)
    cfg = {"IN": l1path, "OUT": d + "/L2_noise_base.asdf", "CALDIR": caldir,
           "SKYORDER": 2, "SLICEOUT": True, "IPC_BACKEND": "auto", "LIN_BACKEND": "auto",
           "SKY_BACKEND": "auto", "PINK_BACKEND": "auto", "CONTRACT_BACKEND": "pallas",
           "NOISE": {"LAYER": layers, "SEED": NOISE_SEED, "BACKEND": "device-strict",
                     "OUT": d + "/noise.asdf"}}
    l1_to_l2.calibrateimage(cfg, device=device)

    # ---- the noise path, counted ----
    reset()
    pearson_torch.rounds = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    noise.generate_all_noise(cfg, device=device)
    torch.cuda.synchronize()
    t_noise = time.perf_counter() - t0
    launches, rounds = read(), pearson_torch.rounds
    for k in NOISE_KERNELS:
        require(launches[k] >= 1, f"noise: kernel {k} was not launched: {launches}")

    na = nside - 2 * NB
    cube = np.asarray(asdf_lite.open(cfg["NOISE"]["OUT"])["noise"])
    require(cube.shape == (len(layers), na, na) and cube.dtype == np.float32,
            f"noise cube {cube.shape} {cube.dtype}")
    require(bool(np.isfinite(cube).all()), "noise cube not finite")
    require(np.array_equal(noise.make_noise_cube(cfg, device=device), cube),
            "noise: the same seed gave another cube")

    # ---- the plain path ----
    cfg_p = dict(cfg, IPC_BACKEND="xla", LIN_BACKEND="xla", SKY_BACKEND="xla",
                 PINK_BACKEND="xla", CONTRACT_BACKEND="dot")
    n0 = read()
    t0 = time.perf_counter()
    plain = noise.make_noise_cube(cfg_p, device=device)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    require(read() == n0, "the plain noise path launched a kernel")
    l2 = asdf_lite.open(cfg["OUT"])["roman"]
    good = np.asarray(l2["dq"]) == 0
    sig = np.asarray(l2["data_withsky"])
    spreads = parity.compare_noise(plain, cube, good, "noise, kernels vs plain")
    o_ratio = {"kernels": parity.o_tracks_signal(cube[1], sig, good, "noise, kernels"),
               "plain": parity.o_tracks_signal(plain[1], sig, good, "noise, plain")}
    del plain, l2, sig
    res = {"phase": "noise", "ok": True, "card": card, "nside": nside, "ngrp": NGRP,
           "layers": layers, "seed": NOISE_SEED, "device": str(device),
           "launches": launches, "type4_rejection_rounds": rounds,
           "synth_s": t_synth, "generate_all_noise_s": t_noise,
           "make_noise_cube_plain_s": t_plain, "good_frac": float(good.mean()),
           "deterministic": True, "kernels_vs_plain": spreads,
           "o_std_bright_over_faint": o_ratio}

    # ---- the warm runner on staged tensors, kernels and plain path in turns ----
    pack = calfiles.load_caldir_cached(caldir)
    l1 = asdf_lite.open(l1path)["roman"]
    fns = {}
    for name, c in (("kernels", cfg), ("plain", cfg_p)):
        prep = l1_to_l2.prepare_inputs(l1, c, pack, device=device)
        run = noise_core.make_staged_noise_runner(prep, pack, layers, c)
        fns[name] = lambda run=run, arr=prep["arr"]: run(NOISE_SEED, arr)
    times = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            times[name].append(cuda_ms(fn, runs=5, warmup=1))
    res["runner_ms"] = times
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res["resident_mem_gb"] = torch.cuda.memory_allocated() / 1e9
    fns["kernels"]()
    torch.cuda.synchronize()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["profile_kernels"] = profile(fns["kernels"], prefix="noise", ours=NOISE_KERNEL_NAMES)
    res["profile_plain"] = profile(fns["plain"], prefix="noise", ours=NOISE_KERNEL_NAMES)
    del fns
    torch.cuda.empty_cache()

    # ---- the likelihood fit under IPC_BACKEND pallas-stream, once ----
    cfg_l = dict(cfg, OUT=d + "/L2_noise_likely.asdf", romancal_ramp_fit=True,
                 IPC_BACKEND="pallas-stream")
    cfg_l["NOISE"] = dict(cfg["NOISE"], OUT=d + "/noise_likely.asdf")
    l1_to_l2.calibrateimage(cfg_l, device=device)
    reset()
    noise.generate_all_noise(cfg_l, device=device)
    torch.cuda.synchronize()
    res["launches_likely_stream"] = read()
    require(res["launches_likely_stream"]["ipc_rev2_cube_stream"] >= 1
            and res["launches_likely_stream"]["ipc_rev2_frame"] == 0,
            f"likelihood noise: launches {res['launches_likely_stream']}")
    cube_l = np.asarray(asdf_lite.open(cfg_l["NOISE"]["OUT"])["noise"])
    require(cube_l.shape == cube.shape and bool(np.isfinite(cube_l).all()),
            "likelihood noise cube")
    res["likely_layers"] = []
    for j in range(len(layers)):
        x = cube_l[j][good]
        lay = {"spread": float(np.percentile(x, 95) - np.percentile(x, 5)),
               "median": float(np.median(x))}
        # tests/test_likely_workflow.py's gates
        require(0.05 < lay["spread"] < 50.0 and abs(lay["median"]) < 0.3,
                f"likelihood noise layer {j}: {lay}")
        res["likely_layers"].append(lay)

    tk = statistics.median(times["kernels"])
    print(f"noise: warm runner {tk:.1f} ms with the kernels, "
          f"{statistics.median(times['plain']):.1f} ms plain; generate_all_noise "
          f"{t_noise:.1f} s; peak memory {res['peak_mem_gb']:.2f} GB", flush=True)
    print(f"noise: Pearson type-4 rejection rounds in the 'O' layer: {rounds}", flush=True)
    print("noise: kernel launches of generate_all_noise: "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; under the likelihood fit (pallas-stream): ipc_rev2_cube_stream "
          f"{res['launches_likely_stream']['ipc_rev2_cube_stream']}", flush=True)
    emit(res)
    return launches, res["launches_likely_stream"]


# --------------------------------------------------------------------------
# Phase 6: L1 -> L2 with the likelihood fit and the slab IPC kernel
# --------------------------------------------------------------------------

L2_FIELDS = ("data", "data_withsky", "dq", "err", "var_poisson", "var_rnoise",
             "dumo", "chisq")


def _require_same_tree(a, b, what):
    for k in L2_FIELDS:
        require(np.array_equal(np.asarray(a["roman"][k]), np.asarray(b["roman"][k])),
                f"{what}: {k} differs")
    for k in ("skycoefs", "endslice", "medsky"):
        require(np.array_equal(np.asarray(a["processinfo"][k]),
                               np.asarray(b["processinfo"][k])), f"{what}: {k} differs")


def phase_likely(card, device, d, caldir, l1path, rate, nside=NSIDE):
    import torch

    from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2

    counters = {k: v for k, v in kernel_counters().items()
                if k in ("linearity", "ipc_rev2_frame", "block_nanmedian") + SLAB_KERNELS}
    base = {"IN": l1path, "CALDIR": caldir, "SKYORDER": 2, "SLICEOUT": True,
            "romancal_ramp_fit": True, "LIN_BACKEND": "auto", "SKY_BACKEND": "auto"}
    cfgs = {"pallas": dict(base, OUT=d + "/L2_likely_slab.asdf", IPC_BACKEND="pallas"),
            "pallas-stream": dict(base, OUT=d + "/L2_likely_stream.asdf",
                                  IPC_BACKEND="pallas-stream"),
            "pallas-frame": dict(base, OUT=d + "/L2_likely_frame.asdf",
                                 IPC_BACKEND="pallas-frame")}
    want = {"pallas": {"linearity": 1, "block_nanmedian": 1, "ipc_rev2_frame": 0,
                       "ipc_rev2_cube_blocked": 1, "correct_cube_fused": 1,
                       "ipc_rev2_cube_stream": 0},
            "pallas-stream": {"linearity": 1, "block_nanmedian": 1, "ipc_rev2_frame": 0,
                              "ipc_rev2_cube_blocked": 0, "correct_cube_fused": 0,
                              "ipc_rev2_cube_stream": 1},
            "pallas-frame": {"linearity": 1, "block_nanmedian": 1, "ipc_rev2_frame": 1,
                             "ipc_rev2_cube_blocked": 0, "correct_cube_fused": 0,
                             "ipc_rev2_cube_stream": 0}}

    # ---- the main path under each IPC route, counted ----
    launches, seconds, outs = {}, {}, {}
    for name, cfg in cfgs.items():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        outs[name] = l1_to_l2.calibrateimage(cfg, device=device, return_arrays=True)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        require(launches[name] == want[name],
                f"IPC_BACKEND {name}: launches {launches[name]}, expected {want[name]}")
    trees = {name: asdf_lite.open(cfg["OUT"]) for name, cfg in cfgs.items()}

    # ---- the L2 product of the blocked route ----
    pack = calfiles.load_caldir_cached(caldir)
    im = trees["pallas"]["roman"]
    na = nside - 2 * NB
    dq = np.asarray(im["dq"])
    good = dq == 0
    require(good.mean() > 0.75, f"good fraction {good.mean()}")
    stats = {}
    for k in ("dumo", "chisq"):
        a = np.asarray(im[k])
        require(a.dtype == np.float16 and a.shape == (na, na), f"L2 {k}: {a.dtype} {a.shape}")
        require(bool(np.isfinite(a[good].astype(np.float32)).all()),
                f"L2 {k} not finite on good pixels")
        stats[k + "_median_good"] = float(np.median(a[good].astype(np.float32)))
    data = np.asarray(im["data"])
    require(data.shape == (na, na) and bool(np.isfinite(data).all()), "L2 data")
    flat = pack.flat[NB:-NB, NB:-NB]
    act_rate = rate[NB:-NB, NB:-NB]
    withsky = np.asarray(im["data_withsky"])
    ratio = float(np.median((withsky * flat)[good] / act_rate[good]))
    corr = float(np.corrcoef(withsky[good], act_rate[good])[0, 1])
    require(0.97 < ratio < 1.03, f"likelihood slope/rate median ratio {ratio}")
    require(corr > 0.9, f"likelihood slope/rate correlation {corr}")
    dumo_ratio = float(np.median((np.asarray(im["dumo"]).astype(np.float32) * flat)[good]
                                 / act_rate[good]))
    require(0.9 < dumo_ratio < 1.1, f"dumo/rate median ratio {dumo_ratio}")
    # the synthetic ramp carries 6 DN of noise on every resultant and no
    # shot noise, which is not the CALDIR's read-noise and gain model,
    # so the median chi-square per dof is reported and not gated
    print(f"likelihood fit: median chisq per dof on good pixels "
          f"{stats['chisq_median_good']:.4f} (reported, not gated)", flush=True)

    # ---- blocked against streaming: bit for bit ----
    _require_same_tree(trees["pallas"], trees["pallas-stream"],
                       "IPC_BACKEND pallas vs pallas-stream")

    # ---- against the plain route: the slab twin, LIN / SKY xla ----
    l1 = asdf_lite.open(l1path)["roman"]
    cfg_p = dict(cfgs["pallas"], LIN_BACKEND="xla", SKY_BACKEND="xla")
    prep_p = l1_to_l2.prepare_inputs(l1, cfg_p, pack, device=device)
    prep_p["cfg"]["ipc"] = "slab-plain"
    core_p = l1_to_l2.make_core(prep_p["plan"], prep_p["cfg"], prep_p["geom"])
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    out_p = l1_to_l2.to_host(core_p(prep_p["arr"]))
    require(all(getattr(mod, attr) == 0 for mod, attr in counters.values()),
            "the plain route launched a kernel")
    require(set(out_p) == set(outs["pallas"]), "plain route: other outputs")
    for k, v in out_p.items():
        require(np.array_equal(v, outs["pallas"][k]),
                f"kernels vs plain route: core output {k} differs")

    # ---- the frame route against its own plain route: the frame twin ----
    cfg_f = dict(cfgs["pallas-frame"], IPC_BACKEND="xla", LIN_BACKEND="xla",
                 SKY_BACKEND="xla")
    prep_f = l1_to_l2.prepare_inputs(l1, cfg_f, pack, device=device)
    out_f = l1_to_l2.to_host(l1_to_l2.make_core(prep_f["plan"], prep_f["cfg"],
                                                prep_f["geom"])(prep_f["arr"]))
    require(all(getattr(mod, attr) == 0 for mod, attr in counters.values()),
            "the frame route's plain route launched a kernel")
    require(set(out_f) == set(outs["pallas-frame"]), "frame plain route: other outputs")
    for k, v in out_f.items():
        require(np.array_equal(v, outs["pallas-frame"][k]),
                f"frame route vs its plain route: core output {k} differs")
    del prep_f, out_f

    # ---- against the frame route: another order of summation ----
    # The two routes round the corrected cube differently by an ulp or
    # two.  This exposure is a 10 DN/s slope on a pedestal of 1e4 DN, so
    # one float32 ulp of the cube (1e-3 DN) is 1e-5 of the slope signal
    # per group: the maps are held to atol 1e-4 max|ref|, ten times the
    # atol between two paths that round alike.  A pixel whose log(u)
    # rounds to a bin edge takes the neighbouring bin's weights under the
    # other route and moves by a share of its noise: up to 1e-3 of the
    # pixels may lie outside (the share is reported).  The sky is held
    # within the bound that the measured difference of ``data_withsky``
    # puts on it, such pixels counted as free (``parity.sky_bounds``).
    parity = _compare_l2(trees["pallas-frame"], trees["pallas"],
                         "slab route vs frame route", loose_bits=4 | 1,
                         sky="derived", atol_frac=1e-4, outside_frac=1e-3)
    print(f"slab vs frame IPC route: largest skycoefs difference "
          f"{parity['skycoefs_max_abs_err']:.3e} of {parity['skycoefs_max_abs']:.3e}, "
          f"bound {max(parity['skycoefs_bound']):.3e}; medsky "
          f"{parity['medsky_abs_err']:.3e}, bound {parity['medsky_bound']:.3e} "
          f"({parity['sky_loose_pixels']} loose pixels)", flush=True)

    res = {"phase": "main_path_likely", "ok": True, "card": card, "nside": nside,
           "ngrp": NGRP, "device": str(device), "launches": launches,
           "calibrateimage_s": seconds, "good_frac": float(good.mean()),
           "slope_over_rate_median": ratio, "slope_rate_corr": corr,
           "dumo_over_rate_median": dumo_ratio, **stats,
           "blocked_vs_stream_bit_exact": True, "kernels_vs_plain_bit_exact": True,
           "frame_route_vs_plain_bit_exact": True,
           "slab_vs_frame_route": parity}
    del outs, out_p, trees, im, data, withsky

    # ---- the warm core: the two slab routes and the plain route in turns ----
    prep = {name: l1_to_l2.prepare_inputs(l1, cfgs[name], pack, device=device)
            for name in ("pallas", "pallas-stream")}
    cores = {name: l1_to_l2.make_core(p["plan"], p["cfg"], p["geom"])
             for name, p in prep.items()}
    runs = {"pallas": lambda: cores["pallas"](prep["pallas"]["arr"]),
            "pallas-stream": lambda: cores["pallas-stream"](prep["pallas-stream"]["arr"]),
            "plain": lambda: core_p(prep_p["arr"])}
    times = {name: [] for name in runs}
    for _ in range(2):
        for name, fn in runs.items():
            times[name].append(cuda_ms(fn, runs=5, warmup=1))
    res["core_ms"] = times
    # peak over one warm call, beside what is resident before it (the
    # staged cal pack and three exposures' inputs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res["resident_mem_gb"] = torch.cuda.memory_allocated() / 1e9
    runs["pallas"]()
    torch.cuda.synchronize()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["profile_kernels"] = profile(runs["pallas"])
    res["profile_stream"] = profile(runs["pallas-stream"])
    res["profile_plain"] = profile(runs["plain"])
    emit(res)
    return {"ipc_rev2_cube_blocked": launches["pallas"]["ipc_rev2_cube_blocked"],
            "correct_cube_fused": launches["pallas"]["correct_cube_fused"],
            "ipc_rev2_cube_stream": launches["pallas-stream"]["ipc_rev2_cube_stream"]}



# --------------------------------------------------------------------------
# Phase 7: sim -> L1
# --------------------------------------------------------------------------

JUMP_DET = 4
EXPTIME = 139.8  # the synthetic scene's exposure time, s


def phase_sim(card, device, d, caldir, nside=NSIDE):
    import torch

    from romanimpreprocess_tpu_torch import pars, synth
    from romanimpreprocess_tpu_torch.config import pattern_to_reads
    from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles, fits_lite
    from romanimpreprocess_tpu_torch.ops import rand, wcsutils
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2, sim_to_l1

    counters = {k: v for k, v in kernel_counters().items()
                if k in ("ipc_fwd_cube", "pink_frames", "contract_reads", "invert_linearity")}
    rp = synth.READ_PATTERN_DEFAULT
    na = nside - 2 * NB
    cw = max(nside // 32, 4)
    t0 = time.perf_counter()
    scene = synth.make_scene_file(d + "/truth_F184_163_4.fits", nside_active=na)
    t_scene = time.perf_counter() - t0
    base = {"IN": scene, "READS": pattern_to_reads(rp), "CALDIR": caldir, "SEED": 200}
    cfg_k = dict(base, OUT=d + "/L1_cuda.asdf", IPC_BACKEND="auto", LIN_BACKEND="auto",
                 PINK_BACKEND="auto", CONTRACT_BACKEND="pallas")
    cfg_p = dict(base, OUT=d + "/L1_plain.asdf", IPC_BACKEND="xla", LIN_BACKEND="xla",
                 PINK_BACKEND="xla", CONTRACT_BACKEND="dot")

    # ---- the main path, counted ----
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    x = sim_to_l1.run_config(cfg_k, device=device)
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t0
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}

    # ---- the L1 file ----
    l1 = asdf_lite.open(cfg_k["OUT"])["roman"]
    data = np.asarray(l1["data"])
    require(data.shape == (NGRP, nside, nside) and data.dtype == np.uint16,
            f"L1 data {data.shape} {data.dtype}")
    a33 = np.asarray(l1["amp33"])
    require(a33.shape == (NGRP, nside, cw) and a33.dtype == np.uint16,
            f"L1 amp33 {a33.shape} {a33.dtype}")
    rdq = np.asarray(l1["resultantdq"])
    require(rdq.shape == (NGRP, na, na) and rdq.dtype == np.uint32,
            f"L1 resultantdq {rdq.shape} {rdq.dtype}")
    require(l1["meta"]["exposure"]["read_pattern"] == rp, "L1 read pattern")
    med = [float(np.median(data[j, NB:-NB, NB:-NB])) for j in range(NGRP)]
    require(all(b > a for a, b in zip(med, med[1:])), f"ramp not increasing: {med}")
    require(abs(float(np.median(a33)) - 29000) < 50, "amp33 off its level")
    sidecar = cfg_k["OUT"][:-5] + "_asdf_wcshead.txt"
    with open(sidecar) as f:
        hdr = fits_lite.Header.fromstring(f.read())
    require("CRVAL1" in hdr and l1["meta"]["wcsinfo"]["CRVAL1"] == float(hdr["CRVAL1"]),
            "WCS sidecar does not match the L1 meta")

    # ---- through calibrateimage: slope recovery, CR envelope, recall ----
    c2 = {"IN": cfg_k["OUT"], "OUT": d + "/L2_of_sim.asdf", "FITSWCS": sidecar,
          "CALDIR": caldir, "SKYORDER": 2, "SLICEOUT": True}
    l1_to_l2.calibrateimage(c2, device=device)
    im = asdf_lite.open(c2["OUT"])["roman"]
    pack = calfiles.load_caldir_cached(caldir)
    act = (slice(NB, -NB), slice(NB, -NB))
    dq = np.asarray(im["dq"])
    good = dq == 0
    require(good.mean() > 0.75, f"good fraction {good.mean()}")
    withsky = np.asarray(im["data_withsky"])
    # against the scene: sky (through flat and gain) is the median residual
    truth = fits_lite.open_fits(scene)[0].data[::-1, :]  # SCA 4: vertical flip
    resid = withsky - truth / pack.gain[act] / EXPTIME
    med_resid = float(np.median(resid[good]))
    require(0.1 < med_resid < 0.5, f"median residual {med_resid} DN/s")
    scale = (na / 120.0) ** 2  # the gates below are stated for 120^2 pixels
    outliers = int((np.abs(np.where(good, resid, 0.0)) > 5).sum())
    require(outliers < 20 * scale, f"{outliers} pixels off by more than 5 DN/s")
    # against the charge rate the sim drew from: truth_rate / gain, less
    # the dark, through flat and pixel area
    area = wcsutils.pixelarea(x.wcs, N=na) / pars.Omega_ideal
    expect = ((x.truth_rate / pack.gain[act] - pack.dark_slope[act])
              / np.clip(pack.flat[act], 0.1, 10.0) * area)
    # faint sky (about 0.26 DN/s): an absolute gate, because one
    # exposure's 1/f realization shifts every slope by a few 0.01 DN/s
    faint = good & (expect > 0.2) & (expect < 1.0)
    sky_offset = float(np.median(withsky[faint] - expect[faint]))
    require(faint.mean() > 0.7 and abs(sky_offset) < 0.1,
            f"sky slope off truth_rate / gain by {sky_offset} DN/s")
    # the stars: a relative gate
    bright = good & (expect > 5.0)
    require(bright.sum() > 100, f"only {bright.sum()} bright pixels")
    ratio = float(np.median(withsky[bright] / expect[bright]))
    require(0.97 < ratio < 1.03, f"slope / (truth_rate / gain) median {ratio}")
    ndet = int(((dq & JUMP_DET) != 0).sum())
    require(2 * scale <= ndet <= 60 * scale, f"{ndet} JUMP_DET pixels")
    hit = (rdq & JUMP_DET).any(axis=0)
    recall = float(((dq & JUMP_DET) != 0)[hit].mean())
    require(hit.sum() >= 2 * scale and recall > 0.5, f"CR recall {recall}")

    # ---- the plain path, same seed ----
    t0 = time.perf_counter()
    sim_to_l1.run_config(cfg_p, device=device)
    torch.cuda.synchronize()
    t_sim_plain = time.perf_counter() - t0
    for name, (mod, attr) in counters.items():
        require(getattr(mod, attr) == launches[name],
                f"the plain sim launched kernel {name}")
    lp = asdf_lite.open(cfg_p["OUT"])["roman"]
    require(np.array_equal(np.asarray(lp["resultantdq"]), rdq),
            "resultantdq differs between the kernel and plain sims")
    parity = {}
    for key, mine in (("data", data), ("amp33", a33)):
        diff = np.abs(mine.astype(np.int32) - np.asarray(lp[key]).astype(np.int32))
        same = float((diff == 0).mean())
        require(int(diff.max()) <= 1, f"{key}: kernel and plain sims differ by {diff.max()} DN")
        require(same >= 0.9, f"{key}: identical on only {same}")
        parity[key] = {"max_abs_diff_dn": int(diff.max()), "identical_share": same}
    print(f"sim kernels vs plain: data identical on {parity['data']['identical_share']:.6f}"
          f" of pixels, amp33 on {parity['amp33']['identical_share']:.6f}", flush=True)
    del lp, diff

    res = {"phase": "sim", "ok": True, "card": card, "nside": nside, "ngrp": NGRP,
           "nreads": rp[-1][-1] + 1, "device": str(device), "launches": launches,
           "scene_s": t_scene, "run_config_s": t_sim, "run_config_plain_s": t_sim_plain,
           "ramp_medians": med, "good_frac": float(good.mean()),
           "median_resid_dn_s": med_resid, "outliers_gt5": outliers,
           "slope_over_truth_rate_median_bright": ratio,
           "n_bright": int(bright.sum()), "sky_slope_minus_truth_dn_s": sky_offset,
           "jump_det": ndet,
           "jump_det_in_reference_10k_30k": bool(10000 <= ndet <= 30000),
           "cr_truth_pixels": int(hit.sum()), "cr_recall": recall,
           "kernels_vs_plain": parity}

    # ---- the warm sim on staged inputs, kernels and plain path in turns ----
    rate = torch.from_numpy(x.truth_rate.astype(np.float32)).to(device)
    del x, im, withsky, resid, expect, truth

    def sim_fn(ipc_b, pink_b, contract):
        def fn():
            gen = rand.sim_generator(200, device)
            cube, _ = sim_to_l1.make_l1_fullcal(
                gen, rate, rp, pack, crparam={}, ipc_backend=ipc_b, contract=contract,
                lin_backend=ipc_b)
            return sim_to_l1.fill_in_refdata_and_1f(
                gen, cube, pack, rp, nside, cw, amp33=np.zeros(1), nborder=NB,
                pink_backend=pink_b)
        return fn

    sim_k, sim_p = sim_fn("cuda", "cuda", "cuda"), sim_fn("xla", "xla", "dot")
    tk, tp = [], []
    for _ in range(2):
        tk.append(cuda_ms(sim_k, runs=5, warmup=1))
        tp.append(cuda_ms(sim_p, runs=5, warmup=1))
    res["sim_ms_kernels"] = tk
    res["sim_ms_plain"] = tp
    res["profile_kernels"] = profile(sim_k, prefix="sim_to_l1", ours=SIM_KERNEL_NAMES)
    res["profile_plain"] = profile(sim_p, prefix="sim_to_l1", ours=SIM_KERNEL_NAMES)
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(res)
    return launches


# --------------------------------------------------------------------------
# Phase 8: the focal plane
# --------------------------------------------------------------------------

FPA_SEED = 9000
FPA_LANES = 18
#: depth cut to keep the script near half its limit: the SCAs of the
#: batch sweep (2 until the calib phase came) and of ``calibrate_fpa``
#: (4 until then; one for each CALDIR path)
FPA_BATCH_SCAS = (4,)
FPA_CALIBRATE_SCAS = 2
#: the kernels every lane of the exposure runner reaches
FPA_KERNELS = ("linearity", "ipc_rev2_frame", "block_nanmedian", "ipc_fwd_cube",
               "pink_frames", "contract_reads", "invert_linearity")


def _same_files(a, b, rels, what):
    """The files ``rels`` under directories ``a`` and ``b``: ASDF trees
    bit for bit (``parity.same_tree``: the L2 log's ``Timing:`` line and
    the directory in the recorded configs aside), other files byte for
    byte."""
    from romanimpreprocess_tpu_torch.io import asdf_lite
    from romanimpreprocess_tpu_torch.utils import parity

    for rel in rels:
        if rel.endswith(".asdf"):
            parity.same_tree(asdf_lite.open(f"{a}/{rel}").tree,
                             asdf_lite.open(f"{b}/{rel}").tree, f"{what}: {rel}",
                             subst=(a, b))
        else:
            with open(f"{a}/{rel}", "rb") as f, open(f"{b}/{rel}", "rb") as g:
                require(f.read() == g.read(), f"{what}: {rel} differs")


def _cold_caches():
    """Empty the port's host and device caches: the next run reads and
    stages its cal packs anew."""
    import torch

    from romanimpreprocess_tpu_torch.io import calfiles
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2

    for cache in (calfiles._PACK_CACHE, l1_to_l2._DEVICE_CACHE,
                  l1_to_l2._IPC_PRECAL_CACHE, l1_to_l2._WCS_CACHE):
        cache.clear()
    torch.cuda.empty_cache()


def phase_fpa(card, d, caldir, l1path, scene):
    """The focal plane at full width on ``cuda``: the 18-lane exposure
    runner, ``calibrate_fpa``, ``batch.run`` serial against ``--fpa``,
    and the Monte-Carlo drivers.  Returns the launches of each kernel in
    the timed 18-lane call."""
    import torch

    from romanimpreprocess_tpu_torch import parallel, synth
    from romanimpreprocess_tpu_torch.config import pattern_to_reads
    from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles
    from romanimpreprocess_tpu_torch.pipeline import batch, l1_to_l2, noise, noise_core
    from romanimpreprocess_tpu_torch.utils import parity
    from romanimpreprocess_tpu_torch.validation import many_realizations

    counters = kernel_counters()
    mesh = parallel.sca_mesh()
    dev = mesh[0]
    rp = synth.READ_PATTERN_DEFAULT
    cw = max(NSIDE // 32, 4)
    act = (slice(NB, -NB), slice(NB, -NB))
    res = {"phase": "fpa", "ok": True, "card": card, "nside": NSIDE, "ngrp": NGRP,
           "mesh": [str(x) for x in mesh]}
    t_phase = time.perf_counter()

    # ---- 1. the exposure runner over 18 lanes ----
    layers = list(batch.DEFAULT_LAYERS)
    cfg = {"IN": l1path, "CALDIR": caldir, "SKYORDER": 2, "IPC_BACKEND": "auto",
           "LIN_BACKEND": "auto", "SKY_BACKEND": "auto", "PINK_BACKEND": "auto",
           "CONTRACT_BACKEND": "pallas"}
    pack = calfiles.load_caldir_cached(caldir)
    l1 = asdf_lite.open(l1path)["roman"]
    prep = l1_to_l2.prepare_inputs(l1, cfg, pack, device=dev)
    t0 = time.perf_counter()
    rates = [synth.injected_rate(NSIDE, 10.0, nborder=NB, seed=s)[act] * pack.gain[act]
             for s in range(FPA_LANES)]
    arr = noise_core.exposure_arrays(prep, rates[0])
    batch_arrs = parallel.broadcast_batch({k: v for k, v in arr.items() if k != "rate"},
                                          FPA_LANES)
    batch_arrs["rate"] = torch.from_numpy(np.stack(rates)).to(dev)
    lanes = parallel.shard_batch(mesh, batch_arrs)
    res["rates_s"] = time.perf_counter() - t0
    run = parallel.make_fpa_exposure_runner(prep, pack, layers, mesh, config=cfg)
    t0 = time.perf_counter()
    warm, _, _ = run(FPA_SEED, lanes[:2])
    torch.cuda.synchronize()
    res["warmup_2_lanes_s"] = time.perf_counter() - t0

    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res["resident_before_gb"] = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    cube, base, checks = run(FPA_SEED, lanes)
    torch.cuda.synchronize()
    res["wall_s_18_lanes"] = time.perf_counter() - t0
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    fpa_launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    lane_s = [t for e in run.timings for t in e["lane_s"]]
    res["lane_s"] = lane_s
    res["median_lane_s"] = statistics.median(lane_s)
    res["launches"] = fpa_launches
    for k in FPA_KERNELS:
        require(fpa_launches[k] >= 1, f"fpa: kernel {k} was not launched: {fpa_launches}")

    na = NSIDE - 2 * NB
    require(tuple(cube.shape) == (FPA_LANES, len(layers), na, na)
            and tuple(checks.shape) == (FPA_LANES,), f"fpa cube {tuple(cube.shape)}")
    require(bool(torch.isfinite(cube).all()), "fpa cube not finite")
    require(torch.equal(warm, cube[:2]), "fpa: two lanes alone differ from the 18-lane call")
    for i in range(1, FPA_LANES):
        require(not torch.equal(cube[0, 0], cube[i, 0]), f"fpa: lanes 0 and {i} agree")
    run_1 = noise_core.make_staged_exposure_runner(prep, pack, layers, config=cfg)
    for i in (0, FPA_LANES - 1):
        c1, b1, k1 = run_1(noise.lane_seed(FPA_SEED, i), lanes[i])
        require(torch.equal(c1, cube[i]) and torch.equal(k1, checks[i])
                and all(torch.equal(b1[k], base[k][i]) for k in b1),
                f"fpa: lane {i} differs from its single-SCA run")
    del c1, b1, k1, warm
    res["lanes_bit_for_bit"] = [0, FPA_LANES - 1]

    # lane 0 against the plain path (every backend xla / dot)
    cfg_p = dict(cfg, IPC_BACKEND="xla", LIN_BACKEND="xla", SKY_BACKEND="xla",
                 PINK_BACKEND="xla", CONTRACT_BACKEND="dot")
    prep_p = l1_to_l2.prepare_inputs(l1, cfg_p, pack, device=dev)
    n0 = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    t0 = time.perf_counter()
    cube_p, _, _ = noise_core.make_staged_exposure_runner(prep_p, pack, layers, cfg_p)(
        noise.lane_seed(FPA_SEED, 0), noise_core.exposure_arrays(prep_p, rates[0]))
    torch.cuda.synchronize()
    res["lane0_plain_s"] = time.perf_counter() - t0
    require(n0 == {k: getattr(mod, attr) for k, (mod, attr) in counters.items()},
            "fpa: the plain lane launched a kernel")
    good = (base["pdq"][0][act] == 0).cpu().numpy()
    res["lane0_vs_plain"] = parity.compare_noise(
        cube_p.cpu().numpy(), cube[0].cpu().numpy(), good, "fpa lane 0, kernels vs plain")
    del cube, base, checks, cube_p, prep_p, lanes, batch_arrs, run, run_1
    torch.cuda.empty_cache()
    print(f"fpa: 18 lanes x {len(layers)} layers at {NSIDE}^2 x {NGRP} groups: "
          f"{res['wall_s_18_lanes']:.2f} s wall, median lane {res['median_lane_s']:.3f} s, "
          f"peak {res['peak_mem_gb']:.2f} GB ({card})", flush=True)

    # ---- 2. calibrate_fpa: one SCA on each of two CALDIR paths ----
    cal = synth.synth_cal_arrays(NSIDE, rp, seed=5)
    l1s = [l1path]
    for s in range(21, 20 + FPA_CALIBRATE_SCAS):
        p = f"{d}/L1_fpa_{s}.asdf"
        synth.write_l1_file(p, synth.synth_l1_cube(cal, rp, seed=s, rate_dn_s=10.0,
                                                   nborder=NB), rp,
                            amp33=synth.synth_amp33(NSIDE, len(rp), cw, seed=s))
        l1s.append(p)
    del cal
    os.makedirs(d + "/cal_link")
    caldir_b = {}
    for k, v in caldir.items():
        caldir_b[k] = f"{d}/cal_link/{os.path.basename(v)}"
        os.symlink(v, caldir_b[k])
    configs = [{"IN": p, "OUT": f"{d}/L2_fpa_{i}.asdf", "CALDIR": (caldir, caldir_b)[i % 2],
                "SKYORDER": 2, "SLICEOUT": True} for i, p in enumerate(l1s)]
    trees, timings = parallel.calibrate_fpa(configs, mesh=mesh, write=True, profile=True)
    res["calibrate_fpa"] = timings
    for i, (c, tree) in enumerate(zip(configs, trees)):
        cs = dict(c, OUT=f"{d}/L2_single_{i}.asdf")
        l1_to_l2.calibrateimage(cs, device=dev)
        single = asdf_lite.open(cs["OUT"])
        parity.same_tree(asdf_lite.open(c["OUT"]).tree, single.tree,
                         f"calibrate_fpa SCA {i} file", subst=(c["OUT"], cs["OUT"]))
        for k in ("data", "dq", "err", "data_withsky"):
            require(np.array_equal(np.asarray(tree["roman"][k]), np.asarray(single["roman"][k])),
                    f"calibrate_fpa SCA {i}: {k} differs from calibrateimage")
        os.remove(cs["OUT"])
    del trees
    print(f"fpa: calibrate_fpa of {FPA_CALIBRATE_SCAS} SCAs (2 CALDIRs): " + ", ".join(
        f"{k} {v:.2f} s" for k, v in timings.items() if k.endswith("_s"))
        + f", compute {timings['groups'][0]['compute_s']:.2f} s, peak "
        f"{timings['peak_mem_gb']:.2f} GB ({card})", flush=True)

    # ---- 3. batch.run, serial against --fpa (each from cold caches) ----
    for sub in ("IN", "CAL"):
        os.makedirs(f"{d}/batch/{sub}")
    for sca in FPA_BATCH_SCAS:
        synth.make_scene_file(f"{d}/batch/IN/Roman_Test_truth_F184_163_{sca}.fits",
                              nside_active=na)
        synth.make_cal_files(f"{d}/batch/CAL/roman_wfi", rp, nside=NSIDE, seed=5,
                             tag="T", sca=sca, channelwidth=cw)
    args = [f"--in={d}/batch/IN", f"--cal={d}/batch/CAL", "--tag=T", "--sca=all",
            "--reads=" + ",".join(map(str, pattern_to_reads(rp))),
            "--layers=Rz4PbrS2C1,Rz4OS2C2"]
    walls = {}
    for name, extra in (("serial", []), ("fpa", ["--fpa"])):
        _cold_caches()  # each run reads its cal sets, as a fresh process would
        t0 = time.perf_counter()
        batch.run(args + [f"--out={d}/batch/{name}"] + extra)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    rels = []
    for sca in FPA_BATCH_SCAS:
        stem = f"F184_163_{sca}"
        rels += [f"L1/sim_L1_{stem}.asdf", f"L1/sim_L1_{stem}_asdf_wcshead.txt",
                 f"L2/sim_L2_{stem}.asdf", f"L2/sim_L2_{stem}_noise.asdf",
                 f"L2/sim_L2_{stem}_mask.fits"]
    _same_files(f"{d}/batch/serial", f"{d}/batch/fpa", rels, "batch --fpa vs serial")
    res["batch_wall_s"] = walls
    shutil.rmtree(f"{d}/batch", ignore_errors=True)
    print(f"fpa: batch.run of {len(FPA_BATCH_SCAS)} SCA(s): serial {walls['serial']:.2f} s, --fpa "
          f"{walls['fpa']:.2f} s, files identical ({card})", flush=True)

    # ---- 4. the Monte-Carlo drivers on the phase-7 scene ----
    c1 = {"IN": scene, "OUT": d + "/val_L1.asdf", "READS": pattern_to_reads(rp),
          "CALDIR": caldir, "SEED": 100}
    c2 = {"IN": d + "/val_L1.asdf", "OUT": d + "/val_L2.asdf",
          "FITSWCS": d + "/val_L1_asdf_wcshead.txt", "CALDIR": caldir, "SKYORDER": 2}
    t0 = time.perf_counter()
    stack_m = many_realizations.run_many_mesh(c1, c2, nrun=4, mesh=mesh)
    res["run_many_mesh_s"] = time.perf_counter() - t0
    res["run_many_mesh"] = parity.mc_stack(stack_m, 3, "run_many_mesh")
    del stack_m
    t0 = time.perf_counter()
    stack_s = many_realizations.run_many(c1, c2, nrun=2, device=dev)
    res["run_many_s"] = time.perf_counter() - t0
    res["run_many"] = parity.mc_stack(stack_s, 2, "run_many")
    del stack_s
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    print(f"fpa: phase {res['phase_s']:.1f} s ({card})", flush=True)
    return fpa_launches


# --------------------------------------------------------------------------
# Phase 9: calibration-file production
# --------------------------------------------------------------------------

CALIB_SEED = 7100
CALIB_SCA = 4
CALIB_DT = 3.04
#: the flat ramps of tests/test_characterize.py: rates (DN/s) and frames
CALIB_RAMPS = ((900.0, 15), (200.0, 20))
CALIB_FRACS = (0.15, 0.4, 0.7, 0.95)
CALIB_CLIP_FRAMES = 100
CALIB_DARKS = 3
#: rows of the CPU slab the card's fit and clip are held to
CALIB_SLAB_ROWS = 128
CALIB_CLIP_SLAB_ROWS = 16


def _toy_linearity(n, gen, dev):
    """The toy curve of ``tests/test_characterize.py:18-31`` at n^2, on
    the card."""
    import torch

    from romanimpreprocess_tpu_torch.ops import linearity

    smin = torch.full((n, n), 4000.0, device=dev)
    smax = 56000 + 2000 * torch.rand((n, n), generator=gen, device=dev)
    sref = smin + 1000
    c2 = 100 + 80 * torch.rand((n, n), generator=gen, device=dev)
    z = 2 * (sref - smin) / (smax - smin) - 1
    c1 = (smax - smin) / 2.0 - 3 * c2 * z
    c0 = -c1 * z - c2 * (1.5 * z**2 - 0.5)
    return linearity.LinearityData(torch.stack([c0, c1, c2, torch.zeros_like(c0)]), smin,
                                   smax, sref, torch.zeros((n, n), dtype=torch.int32,
                                                           device=dev))


def _linearised(pack, S):
    """``S`` (ny, nx) through a linearity pack (the fit's host dict or a
    ``LinearityData``), on ``S``'s device."""
    import torch

    from romanimpreprocess_tpu_torch.ops import linearity

    if isinstance(pack, dict):
        pack = linearity.LinearityData(
            *(torch.from_numpy(pack[k]).to(S.device) for k in ("data", "Smin", "Smax", "Sref")),
            torch.from_numpy(pack["dq"].view(np.int32)).to(S.device))
    return linearity.apply_linearity_cube(S[None], pack)[0][0]


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)


def phase_calib(card, device, d, caldir, l1path, nside=NSIDE):
    """Calibration-file production at 4096^2 on ``cuda``: the linearity
    fit (recovery, the CPU's fit on a slab, time, peak memory), the
    sigma-clipped stack of 100 dark frames (the CPU's clip on a slab),
    and the file chain of ``runs/production/make_sca_files.job`` from
    raw frames to a CALDIR that calibrates the main path's L1."""
    import torch

    from romanimpreprocess_tpu_torch import synth
    from romanimpreprocess_tpu_torch.calib import (characterize, convert, make_dark,
                                                   make_gain, makemask, postprocess)
    from romanimpreprocess_tpu_torch.config import pattern_to_reads
    from romanimpreprocess_tpu_torch.io import asdf_lite, fits_lite
    from romanimpreprocess_tpu_torch.ops import linearity
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2

    dev = device
    gen = torch.Generator(device=dev).manual_seed(CALIB_SEED)
    n = nside
    res = {"phase": "calib", "ok": True, "card": card, "nside": n}
    t_phase = time.perf_counter()

    # ---- 1. the linearity fit ----
    lin = _toy_linearity(n, gen, dev)
    ts = [np.arange(1, k + 1) * CALIB_DT for _, k in CALIB_RAMPS]
    ramps = [torch.stack([linearity.invert_linearity(
        torch.full((n, n), a * t, device=dev), lin)[0] for t in tt])
        for (a, _), tt in zip(CALIB_RAMPS, ts)]
    bias = linearity.invert_linearity(torch.zeros((n, n), device=dev), lin)[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fit = characterize.fit_linearity(ramps, ts, bias, p_order=6, n_iter=4, device=dev)
    torch.cuda.synchronize()
    res["fit_linearity_s"] = time.perf_counter() - t0
    res["fit_linearity_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["fit_linearity_working_set_gb"] = (torch.cuda.max_memory_allocated() - before) / 1e9
    res["fit_dq_frac"] = float(fit["dq"].mean())
    rows = slice(0, CALIB_SLAB_ROWS)
    t0 = time.perf_counter()
    fit_cpu = characterize.fit_linearity([r[:, rows].cpu() for r in ramps], ts,
                                         bias[rows].cpu(), p_order=6, n_iter=4,
                                         device="cpu")
    res["fit_linearity_cpu_slab_s"] = time.perf_counter() - t0
    for k in ("Smin", "Smax", "Sref", "dq"):
        require(np.array_equal(fit[k][rows], fit_cpu[k]),
                f"calib: the fit's {k} on the card differs from the CPU's")
    top = ramps[0][-1]
    recovery, vs_cpu = [], []
    for frac in CALIB_FRACS:
        S = bias + frac * (top - bias)
        want = _linearised(lin, S)
        got = _linearised(fit, S)
        rel = (got - want).abs() / torch.clamp(want.abs(), min=100.0)
        recovery.append(float(rel.median()))
        a = _linearised(fit_cpu, S[rows].cpu()).numpy()
        b = got[rows].cpu().numpy()
        rel_c = np.abs(b - a) / np.maximum(np.abs(a), 100.0)
        vs_cpu.append([float(np.median(rel_c)), float(rel_c.max())])
    res["fit_recovery_median_rel"] = recovery
    res["fit_vs_cpu_slab_rel"] = vs_cpu
    require(max(recovery) < 0.03, f"calib: the fit misses the toy curve: {recovery}")
    require(all(m < 1e-4 and x < 1e-3 for m, x in vs_cpu),
            f"calib: the card's fit differs from the CPU's on the slab: {vs_cpu}")
    del fit, fit_cpu
    print(f"calib: fit_linearity at {n}^2 (p_order 6, {sum(k for _, k in CALIB_RAMPS)} "
          f"frames): {res['fit_linearity_s']:.2f} s, peak "
          f"{res['fit_linearity_peak_gb']:.2f} GB ({card})", flush=True)

    # ---- 2. the sigma-clipped stack of 100 dark frames ----
    torch.cuda.empty_cache()
    stack = torch.empty((CALIB_CLIP_FRAMES, n, n + n // 32), device=dev)
    stack.normal_(1000.0, 5.0, generator=gen)
    u = torch.rand(stack.shape, generator=gen, device=dev)
    stack += torch.where(u < 0.01, 50.0 + 5e5 * u, 0.0)  # hits of 50-5050 DN
    stack[u > 0.995] = float("nan")
    del u
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mean, count = make_dark.sigma_clip_mean(stack, counts=True)
    torch.cuda.synchronize()
    res["sigma_clip_s"] = time.perf_counter() - t0
    res["sigma_clip_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rows = slice(0, CALIB_CLIP_SLAB_ROWS)
    m_cpu, c_cpu = make_dark.sigma_clip_mean(stack[:, rows].cpu(), counts=True)
    require(np.array_equal(count[rows].cpu().numpy(), c_cpu.numpy()),
            "calib: the clip's survivor counts differ from the CPU's")
    m_gpu = mean[rows].cpu().numpy()
    res["sigma_clip_vs_cpu_max_rel"] = float(np.max(np.abs(m_gpu - m_cpu.numpy())
                                                    / np.abs(m_cpu.numpy())))
    require(np.allclose(m_gpu, m_cpu.numpy(), rtol=1e-6, atol=0),
            "calib: the clipped means differ from the CPU's beyond rtol 1e-6")
    res["sigma_clip_median_survivors"] = float(count.float().median())
    res["sigma_clip_median_abs_dev"] = float((mean - 1000.0).abs().median())
    require(res["sigma_clip_median_abs_dev"] < 1.0, f"calib: clipped mean {res}")
    del stack, mean, count
    torch.cuda.empty_cache()
    print(f"calib: sigma_clip_mean of {CALIB_CLIP_FRAMES} x {n} x {n + n // 32}: "
          f"{res['sigma_clip_s']:.2f} s ({card})", flush=True)

    # ---- 3. the file chain, raw frames to a CALDIR ----
    cd = d + "/calib"
    os.makedirs(cd + "/raw")
    peak = [0]

    def meter():
        peak[0] = max(peak[0], _dir_bytes(cd))

    rp = synth.READ_PATTERN_DEFAULT
    reads = pattern_to_reads(rp)
    nframes = rp[-1][-1] + 1
    naug = n + n // 32
    steps = {}
    t0 = time.perf_counter()
    dark_slope = 0.05 * 10.0 ** (-0.3 + 0.5 * torch.randn((n, naug), generator=gen,
                                                           device=dev))
    bias_raw = 12000 + 100 * torch.cos(torch.arange(naug, device=dev) / 17.0)[None, :]
    noise_files = []
    for e in range(1, CALIB_DARKS + 1):
        frames = []
        for k in range(nframes):
            img = bias_raw + dark_slope * CALIB_DT * k + 6.0 * torch.randn(
                (n, naug), generator=gen, device=dev)
            frame = torch.clamp(torch.round(img), 0, 65535).to(torch.int32)
            frame = frame.flip(0).cpu().numpy().astype(np.uint16)  # SCA 4: detector rows
            h = fits_lite.Header()
            h["DATE"] = f"2026-01-01T00:{e:02d}:{k:02d}"
            frames.append(f"{cd}/raw/frame_{k:03d}.fits")
            fits_lite.PrimaryHDU(frame, header=h).writeto(frames[-1])
        meter()
        noise_files.append(f"{cd}/99999999_SCA{CALIB_SCA:02d}_Noise_{e:03d}.fits")
        convert.convert_exposure(frames, noise_files[-1], CALIB_SCA, frame_time=CALIB_DT)
        meter()
        for f in frames:
            os.remove(f)
    steps["convert_s"] = time.perf_counter() - t0

    # the solid-waffle noise summary (tests/test_calib.py's fixture)
    planes = np.zeros((6, n, naug), np.float32)
    h = fits_lite.Header()
    h["DARK1"], h["DARK1ERR"], h["DARK2"], h["DARK2ERR"] = 0, 1, 2, 3
    h["CDS"], h["RESET"] = 4, 5
    h["ACN"], h["C_PINK"], h["U_PINK"] = 0.1, 0.8, 0.4
    planes[0] = planes[2] = (dark_slope / CALIB_DT).cpu().numpy()
    planes[1], planes[3], planes[4], planes[5] = 0.01, 0.005, 8.5, 27.0
    a33 = np.zeros((2, n, n // 32), np.float32)
    a33[0], a33[1] = 29000.0, 4.0
    ah = fits_lite.Header()
    ah["EXTNAME"] = "AMP33"
    ah["M_PINK"], ah["RU_PINK"] = 0.8, 1.0
    summary = cd + "/noise_summary.fits"
    fits_lite.HDUList([fits_lite.PrimaryHDU(), fits_lite.HDU(planes, header=h),
                       fits_lite.HDU(a33, header=ah)]).writeto(summary)
    del planes
    stem = f"{cd}/roman_wfi_{{}}_CHIP_SCA{CALIB_SCA:02d}.asdf"
    out = {k: stem.format(f) for k, f in (
        ("dark", "dark"), ("read", "read"), ("gain", "gain"), ("ipc4d", "ipc4d"),
        ("linearitylegendre", "linearitylegendre"), ("flat", "pflat"),
        ("saturation", "saturation"), ("biascorr", "biascorr"), ("mask", "mask"))}
    t0 = time.perf_counter()
    make_dark.make_dark_and_read_files("CHIP", reads, noise_files, summary, CALIB_SCA,
                                       out["dark"], nside=n, device=dev)
    steps["make_dark_s"] = time.perf_counter() - t0
    meter()
    for f in noise_files + [summary]:
        os.remove(f)

    # two solid-waffle gain summaries (8 x 8 superpixels, one without data)
    sfiles = []
    rows_sw = []
    for iy in range(8):
        for ix in range(8):
            row = np.zeros(12)
            row[[0, 1]] = ix, iy
            row[2] = 100 if (ix, iy) != (3, 3) else 0
            row[5], row[6], row[7], row[10] = 1.5 + 0.01 * ix, 0.013, 0.015, 0.002
            rows_sw.append(row)
    for j in range(2):
        sfiles.append(f"{cd}/sw_summary_{j}.txt")
        np.savetxt(sfiles[-1], np.array(rows_sw))
    t0 = time.perf_counter()
    make_gain.make_gain_and_ipc_files(sfiles, CALIB_SCA, out["gain"], nside=n)
    steps["make_gain_s"] = time.perf_counter() - t0
    meter()
    t0 = time.perf_counter()
    characterize.make_linearity_file(out["linearitylegendre"], CALIB_SCA, ramps, ts, bias,
                                     p_order=6, n_iter=4, device=dev)
    steps["make_linearity_file_s"] = time.perf_counter() - t0
    del ramps, bias, lin
    torch.cuda.empty_cache()
    meter()
    t0 = time.perf_counter()
    postprocess.make_pflat_file(out["linearitylegendre"], out["gain"], out["flat"],
                                CALIB_SCA, device=dev)
    steps["make_pflat_s"] = time.perf_counter() - t0
    meter()
    postprocess.make_saturation_file(out["linearitylegendre"], out["saturation"], CALIB_SCA)
    meter()
    t0 = time.perf_counter()
    postprocess.make_biascorr_file(out["linearitylegendre"], out["dark"], out["biascorr"],
                                   CALIB_SCA, reads, frame_time=CALIB_DT, device=dev)
    steps["make_biascorr_s"] = time.perf_counter() - t0
    meter()
    makemask.make_mask_file(out["mask"], CALIB_SCA, out["linearitylegendre"], out["dark"],
                            gain_file=out["gain"], nside=n)
    meter()
    res["chain_steps_s"] = steps
    res["chain_disk_peak_gb"] = peak[0] / 1e9
    res["caldir_gb"] = sum(os.path.getsize(p) for p in out.values()) / 1e9

    # the produced files in place of their counterparts: calibrate the L1
    t0 = time.perf_counter()
    l2 = cd + "/L2_calib.asdf"
    l1_to_l2.calibrateimage({"IN": l1path, "OUT": l2, "CALDIR": dict(caldir, **out),
                             "SKYORDER": 2}, device=dev)
    res["calibrateimage_s"] = time.perf_counter() - t0
    im = asdf_lite.open(l2)["roman"]
    good = np.asarray(im["dq"]) == 0
    data = np.asarray(im["data"])
    res["good_frac"] = float(good.mean())
    require(res["good_frac"] > 0.5, f"calib: good pixels {res['good_frac']}")
    require(bool(np.isfinite(data[good]).all()), "calib: non-finite data on good pixels")
    shutil.rmtree(cd, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    print(f"calib: file chain {sum(steps.values()):.1f} s, disk peak "
          f"{res['chain_disk_peak_gb']:.2f} GB (CALDIR {res['caldir_gb']:.2f} GB); "
          f"phase {res['phase_s']:.1f} s ({card})", flush=True)


# --------------------------------------------------------------------------

def main():
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available: this script runs only on a GPU")
    if not os.path.isdir(os.path.join(ROOT, "romanimpreprocess_tpu_torch", "csrc")):
        raise SmokeError("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, ROOT)
    from romanimpreprocess_tpu_torch.ops import cuda_build

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    card = f"{kind} ({smi})"
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
          "ptxas": {src: [ln.strip() for ln in p.with_suffix(".log").read_text()
                          .splitlines() if "registers" in ln or "spill" in ln]
                    for src, p in libs.items()}})

    full = phase_kernels(card)
    phase_plain_devices(card)
    d = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        caldir = make_caldir(d, NSIDE)
        launches, backends, l1path, rate = phase_main(
            card, torch.device("cuda"), d, caldir)
        torch.cuda.empty_cache()
        spatial_launches, spatial_slab_launches = phase_spatial(
            card, torch.device("cuda"), d, caldir, l1path)
        torch.cuda.empty_cache()
        noise_launches, noise_launches_likely = phase_noise(
            card, torch.device("cuda"), d, caldir)
        torch.cuda.empty_cache()
        launches.update(phase_likely(card, torch.device("cuda"), d, caldir,
                                     l1path, rate))
        del rate
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches.update(phase_sim(card, torch.device("cuda"), d, caldir))
        torch.cuda.empty_cache()
        fpa_launches = phase_fpa(card, d, caldir, l1path,
                                 d + "/truth_F184_163_4.fits")
        torch.cuda.empty_cache()
        phase_calib(card, torch.device("cuda"), d, caldir, l1path)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    require(all(b == "cuda" for b in backends.values()),
            f"auto did not resolve to the CUDA kernels: {backends}")
    for name in KERNELS:
        require(launches[name] >= 1,
                f"kernel {name} was not launched on its main path")

    kernels = []
    for name, meta in KERNELS.items():
        r = full[name]
        kernels.append(dict(
            name=name, **meta, launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            # launches in the noise phase's generate_all_noise call, and
            # in the one under the likelihood fit and pallas-stream
            noise_launches=noise_launches[name],
            noise_launches_likely_stream=noise_launches_likely[name],
            # launches in the focal-plane phase's timed 18-lane call
            fpa_launches=fpa_launches[name],
            # launches in the row-sharded classic core on two entries, and
            # in its likelihood fit under pallas and pallas-stream
            spatial_launches=spatial_launches[name],
            spatial_slab_launches=spatial_slab_launches[name]))
    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # noqa: BLE001 -- report and fail, never exit 0
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        import traceback

        traceback.print_exc()
        sys.exit(1)
