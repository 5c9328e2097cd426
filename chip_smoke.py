#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit; the kernels are built from
   ``romanimpreprocess_tpu_torch/csrc`` into ``build/torch_ext/``.
2. kernels: each hand-written CUDA kernel (linearity, IPC frame inverse,
   block nanmedian) against its plain PyTorch version on the card, at
   the main path's shapes (4096^2 x 6 groups; the 4088^2 active frame
   with N=8) and at small ragged shapes; CUDA-event medians of the
   kernel, the plain version and, where one exists, a single PyTorch
   call computing the same function; the least time the card could
   take (bytes over the memory rate, operations over the f32 rate).
3. main path: a synthetic 4096^2 CALDIR and 6-group L1 through
   ``calibrateimage`` on ``cuda`` with every backend ``auto``
   (SKYORDER 2, SLICEOUT), kernel launch counts read around that run;
   the L2 checked (finite, DQ populated, injected rate recovered) and
   held against the plain path on the card (every backend ``xla``);
   the warm core timed with CUDA events, kernels and plain path in
   turns.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
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


def bound(nbytes, nops, name):
    """(bound_ms, bound_by): the larger of bytes / memory rate and
    operations / f32 rate."""
    t_bytes = nbytes / hbm_rate(name) * 1e3
    t_ops = nops / F32_RATE * 1e3
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


def profile(fn, top=10):
    """One warm call under torch.profiler: device time per stage of the
    core (its ``l1_to_l2.*`` ranges) and per kernel name, the kernel
    count, and the device's idle share of the span from the first
    kernel's start to the last one's end."""
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
            and not e.name.startswith("l1_to_l2.")]
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
              if e.key.startswith("l1_to_l2.")}
    ours = {name: sum(t for k, (t, _) in by_name.items() if name in k) / 1e3
            for name in ("linearity_kernel", "ipc_rev2_frame_kernel",
                         "block_nanmedian_kernel")}
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


def ipc_inputs(ngrp, nside, gen, dev):
    import torch

    na = nside - 2 * NB
    planes = torch.zeros((9, nside, nside), device=dev)
    planes[:, NB:-NB, NB:-NB] = torch.rand((9, na, na), generator=gen,
                                           device=dev) * 0.02
    planes[4, NB:-NB, NB:-NB] = 1.0 - (planes[:, NB:-NB, NB:-NB].sum(0)
                                       - planes[4, NB:-NB, NB:-NB])
    data = torch.rand((ngrp, nside, nside), generator=gen, device=dev) * 1000.0
    gain = 1.4 + 0.2 * torch.rand((nside, nside), generator=gen, device=dev)
    return data, planes.contiguous(), gain


def med_inputs(ny, nx, N, gen, dev, nan_frac=0.05):
    import torch

    from romanimpreprocess_tpu_torch.ops.sky import block_geometry

    arr = torch.randn((ny, nx), generator=gen, device=dev) * 100.0
    arr[torch.rand((ny, nx), generator=gen, device=dev) < nan_frac] = float("nan")
    ky, kx, py, px = block_geometry(ny, nx, N)
    arr[py : py + ky, px : px + kx] = float("nan")  # one all-NaN block
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


def check_ipc(ngrp, nside, gen, dev, timed, card):
    import torch

    from romanimpreprocess_tpu_torch.ops import ipc_cuda

    data, planes, gain = ipc_inputs(ngrp, nside, gen, dev)
    got = ipc_cuda.ipc_rev2_frame(data, planes, gain, nborder=NB)
    ref = ipc_cuda.ipc_rev2_frame_plain(data, planes, gain, nborder=NB)
    torch.cuda.synchronize()
    border = torch.ones((nside, nside), dtype=torch.bool, device=dev)
    border[NB:-NB, NB:-NB] = False
    require(torch.equal(got[:, border], data[:, border]),
            f"ipc {nside}: border not passed through")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    # the kernel repeats the plain version's rounded steps in its order,
    # so it should be bit-exact; the gate is 1e-5 of scale, the JAX
    # package's own gate for its Pallas kernel
    require(err <= 1e-5 * scale, f"ipc {nside}: err {err} of {scale}")
    res = {"shape": [ngrp, nside, nside], "max_abs_err": err,
           "max_rel_err": err / scale, "bit_exact": bool(torch.equal(got, ref))}
    if timed:
        res["ms"] = cuda_ms(lambda: ipc_cuda.ipc_rev2_frame(data, planes, gain, NB))
        res["plain_ms"] = cuda_ms(lambda: ipc_cuda.ipc_rev2_frame_plain(
            data, planes, gain, NB))
        res["library_ms"] = None  # no single PyTorch call computes it
        na = nside - 2 * NB
        res["bound_ms"], res["bound_by"] = bound(
            ipc_cuda.bytes_moved(ngrp, nside), ngrp * na * na * 42, card)
    return res


def check_med(ny, nx, N, gen, dev, timed, card):
    import torch

    from romanimpreprocess_tpu_torch.ops import median_cuda, sky

    arr = med_inputs(ny, nx, N, gen, dev)
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
    res = {"shape": [ny, nx], "N": N, "max_abs_err": 0.0, "bit_exact": True}
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
    return res


KERNELS = {
    "linearity": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/linearity.cu",
        replaces="romanimpreprocess_tpu/ops/linearity_pallas.py:70"),
    "ipc_rev2_frame": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/ipc_frame.cu",
        replaces="romanimpreprocess_tpu/ops/ipc_pallas.py:425"),
    "block_nanmedian": dict(
        route="cuda", source="romanimpreprocess_tpu_torch/csrc/blockmed.cu",
        replaces="romanimpreprocess_tpu/ops/median_pallas.py:55"),
}


def phase_kernels(card):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20240901)
    out = {}
    small = {
        "linearity": [check_lin((NGRP, 128, 128), gen, dev, False, card),
                      check_lin((3, 120, 130), gen, dev, False, card)],
        "ipc_rev2_frame": [check_ipc(NGRP, 128, gen, dev, False, card),
                           check_ipc(3, 120, gen, dev, False, card)],
        "block_nanmedian": [check_med(130, 125, 8, gen, dev, False, card),
                            check_med(128, 120, 4, gen, dev, False, card)],
    }
    emit({"phase": "kernels_small", "ok": True, "results": small})
    na = NSIDE - 2 * NB
    out["linearity"] = check_lin((NGRP, NSIDE, NSIDE), gen, dev, True, card)
    torch.cuda.empty_cache()
    out["ipc_rev2_frame"] = check_ipc(NGRP, NSIDE, gen, dev, True, card)
    torch.cuda.empty_cache()
    out["block_nanmedian"] = check_med(na, na, 8, gen, dev, True, card)
    torch.cuda.empty_cache()
    emit({"phase": "kernels_full", "ok": True, "card": card, "results": out})
    return out


# --------------------------------------------------------------------------
# Phase 3: the main path
# --------------------------------------------------------------------------

def _compare_l2(ref, got, what):
    """The slice's parity rules: DQ bit-exact except JUMP_DET on at most
    1e-4 of pixels; science/variance maps within rtol 1e-5 and atol
    1e-5 max|ref|; sky coefficients within rtol 1e-4; endslice exact."""
    jump = 4
    rr, gr = ref["roman"], got["roman"]
    dq_r, dq_g = np.asarray(rr["dq"]), np.asarray(gr["dq"])
    diff = dq_r ^ dq_g
    require(not (diff & ~np.uint32(jump)).any(), f"{what}: DQ differs beyond JUMP_DET")
    jump_frac = float((diff != 0).mean())
    require(jump_frac <= 1e-4, f"{what}: JUMP_DET differs on {jump_frac}")
    res = {"jump_det_diff_frac": jump_frac}
    for k in ("data", "data_withsky", "err", "var_poisson", "var_rnoise"):
        r, g = np.asarray(rr[k]), np.asarray(gr[k])
        scale = float(np.abs(r).max())
        ok = np.abs(g - r) <= 1e-5 * np.abs(r) + 1e-5 * scale
        # pixels whose JUMP_DET flag differs may fit other slopes
        ok |= (diff != 0)
        res[k + "_max_abs_err"] = float(np.abs(g - r).max())
        require(bool(ok.all()), f"{what}: {k} differs ({res[k + '_max_abs_err']} of {scale})")
    rp, gp = ref["processinfo"], got["processinfo"]
    sc_r, sc_g = np.asarray(rp["skycoefs"]), np.asarray(gp["skycoefs"])
    require(np.allclose(sc_g, sc_r, rtol=1e-4, atol=1e-4 * np.abs(sc_r).max()),
            f"{what}: skycoefs {sc_g} vs {sc_r}")
    require(np.array_equal(np.asarray(rp["endslice"]), np.asarray(gp["endslice"])),
            f"{what}: endslice differs")
    res["skycoefs_max_abs_err"] = float(np.abs(sc_g - sc_r).max())
    res["bit_exact"] = bool(
        np.array_equal(dq_r, dq_g) and np.array_equal(sc_r, sc_g)
        and all(np.array_equal(np.asarray(rr[k]), np.asarray(gr[k]))
                for k in ("data", "data_withsky", "err", "var_poisson", "var_rnoise")))
    return res


def make_inputs(d, nside, rate_dn_s=10.0):
    """Synthetic CALDIR + L1 (the port's synth) in directory ``d``;
    returns (caldir, L1 path, injected rate map)."""
    from romanimpreprocess_tpu_torch import synth

    rp = synth.READ_PATTERN_DEFAULT
    caldir = synth.make_cal_files(d + "/roman_wfi", rp, nside=nside, seed=5,
                                  channelwidth=max(nside // 32, 4))
    cal = synth.synth_cal_arrays(nside, rp, seed=5)
    data = synth.synth_l1_cube(cal, rp, seed=7, rate_dn_s=rate_dn_s, nborder=NB)
    rate = synth.injected_rate(nside, rate_dn_s, nborder=NB, seed=7)
    del cal
    amp33 = synth.synth_amp33(nside, len(rp), max(nside // 32, 4))
    synth.write_l1_file(d + "/L1.asdf", data, rp, amp33=amp33)
    return caldir, d + "/L1.asdf", rate


def phase_main(card, device, nside=NSIDE):
    import torch

    from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles
    from romanimpreprocess_tpu_torch.ops import ipc_cuda, linearity_cuda, median_cuda
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2

    mods = {"linearity": linearity_cuda, "ipc_rev2_frame": ipc_cuda,
            "block_nanmedian": median_cuda}
    d = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        caldir, l1path, rate = make_inputs(d, nside)
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
        emit(res)
        return launches, backends
    finally:
        shutil.rmtree(d, ignore_errors=True)


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
    launches, backends = phase_main(card, torch.device("cuda"))
    require(all(b == "cuda" for b in backends.values()),
            f"auto did not resolve to the CUDA kernels: {backends}")
    for name, n in launches.items():
        require(n >= 1, f"kernel {name} was not launched on the main path")

    kernels = []
    for name, meta in KERNELS.items():
        r = full[name]
        kernels.append(dict(
            name=name, **meta, launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
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
