"""Focal-plane batching over a mesh of torch devices.

The reference's only parallelism is Slurm array jobs, one process per
SCA (``runs/summer2025run/OpenUniverse_to_L1L2.job:4``).  Here one
process drives the 18-SCA focal plane.  A mesh is an ordered tuple of
torch devices (:func:`sca_mesh`).  The SCAs of a batch (its lanes) are
assigned round-robin to the mesh entries; each entry works through its
lanes one after another, on a thread of its own when the mesh has
several entries, through the unchanged single-SCA core
(:func:`..pipeline.l1_to_l2.make_core`) and staged runners
(:mod:`..pipeline.noise_core`).  No lane is batched into a kernel and
none is padded, so every lane gives the single-SCA result bit for bit.
Several entries may name one device (``sca_mesh(devices=["cpu",
"cpu"])``: two workers on one device).

Streams, threads, generators.  Every thread issues its work on its
device's current stream (PyTorch's default stream unless a caller sets
another), so what the threads sharing a device issue runs in issue
order on one stream, and a tensor staged by one thread is ready for
what another issues after it.  Each lane draws from generators of its
own (:func:`..pipeline.noise.stream`), never shared across threads.  The
host caches the threads share take a lock (:mod:`..utils.hostcache`,
:func:`..io.calfiles.load_caldir_cached`).  The kernel wrappers' launch
counters are plain integers, exact only while one thread launches: a
counted run uses a one-entry mesh.
"""

import contextlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import resolve_device
from ..io import asdf_lite, calfiles
from ..io.staging import place
from ..pipeline import l1_to_l2
from ..utils import typefix


def sca_mesh(n_devices=None, devices=None):
    """The mesh: an ordered tuple of torch devices.

    By default every CUDA device (the first ``n_devices``); raises
    without one.  ``devices`` lists the entries explicitly, repeats
    included (``["cpu", "cpu"]``: two workers on the CPU).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass devices=['cpu', ...] to run the "
                "plain PyTorch path on the CPU")
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(f"asked for {n} CUDA devices, {count} present")
        devices = [torch.device("cuda", i) for i in range(n)]
    mesh = tuple(resolve_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def device_context(device):
    """Make ``device`` the thread's current CUDA device (a no-op on the
    CPU), so that kernels launched through ``ctypes`` run there."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def broadcast_batch(arrays, n_sca):
    """A single-SCA bundle (tensors or numpy arrays) with a leading SCA
    axis of ``n_sca`` lanes, as stride-0 views: nothing is copied, and
    :func:`shard_batch` places each shared array once per device."""
    out = {}
    for k, v in arrays.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.unsqueeze(0).expand((n_sca,) + tuple(v.shape))
        else:
            v = np.asarray(v)
            out[k] = np.broadcast_to(v[None], (n_sca,) + v.shape)
    return out


def _shared(v):
    """Every lane of ``v`` is the same memory (a stride-0 lane axis)."""
    if isinstance(v, torch.Tensor):
        return v.stride(0) == 0
    return np.asarray(v).strides[0] == 0


def shard_batch(mesh, arrays):
    """Lane ``i``'s slice of every array of a stacked batch (leading SCA
    axis), placed on mesh entry ``i % len(mesh)``: a list of per-lane
    dicts.  An array shared by every lane (stride 0, as
    :func:`broadcast_batch` makes them) is placed once per device."""
    n = len(next(iter(arrays.values())))
    placed, lanes = {}, []
    for i in range(n):
        dev = mesh[i % len(mesh)]
        lane = {}
        for k, v in arrays.items():
            if _shared(v):
                key = (k, str(dev))
                if key not in placed:
                    placed[key] = place(v[0], dev)
                lane[k] = placed[key]
            else:
                lane[k] = place(v[i], dev)
        lanes.append(lane)
    return lanes


def lanes_of(mesh, batch):
    """A batch as per-lane dicts: a list passes through, a stacked dict
    goes through :func:`shard_batch`."""
    return batch if isinstance(batch, list) else shard_batch(mesh, batch)


def run_lanes(mesh, fn, n):
    """``fn(i, device)`` for every lane ``i < n``, lane ``i`` on mesh
    entry ``i % len(mesh)``; each entry works through its lanes in
    order, waiting for the device at the end of each.  Returns one
    ``{"device", "n_sca", "pad", "compute_s", "lane_s"}`` entry per mesh
    entry (``lane_s``: the wall time of each of its lanes)."""
    def entry(e):
        dev = mesh[e]
        idxs = range(e, n, len(mesh))
        t0 = time.perf_counter()
        lane_s = []
        with device_context(dev):
            for i in idxs:
                t = time.perf_counter()
                fn(i, dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                lane_s.append(time.perf_counter() - t)
        return {"device": str(dev), "n_sca": len(idxs), "pad": 0,
                "compute_s": time.perf_counter() - t0, "lane_s": lane_s}

    if len(mesh) == 1:
        return [entry(0)]
    with ThreadPoolExecutor(len(mesh)) as pool:
        return list(pool.map(entry, range(len(mesh))))


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


class LaneStack:
    """Lane outputs (a tensor, or tuples / dicts of tensors) written into
    tensors with a leading lane axis on ``device`` as each lane ends, so
    that only the stacked result and the running lanes are resident."""

    def __init__(self, n, device):
        self.n, self.device = n, device
        self.out = None
        self._lock = threading.Lock()

    def put(self, i, tree):
        with self._lock:
            if self.out is None:
                self.out = _tree_map(
                    lambda t: torch.empty((self.n,) + tuple(t.shape), dtype=t.dtype,
                                          device=self.device), tree)
        _tree_map(lambda o, t: o[i].copy_(t), self.out, tree)

    def result(self):
        return self.out


def run_stacked(mesh, fn, lanes, timings=None):
    """``fn(i, lane)`` over the lanes on their mesh entries, the outputs
    stacked on the first entry's device (:class:`LaneStack`);
    ``timings``, a list, receives :func:`run_lanes`' entries."""
    stack = LaneStack(len(lanes), mesh[0])
    entries = run_lanes(mesh, lambda i, dev: stack.put(i, fn(i, lanes[i])), len(lanes))
    if timings is not None:
        timings[:] = entries
    return stack.result()


def make_fpa_calibrator(plan, cfg, geom, mesh):
    """The L1 -> L2 core over a batch of SCAs: ``run(batch)`` takes a
    stacked dict (leading SCA axis) or a :func:`shard_batch` list, runs
    lane ``i`` on entry ``i % len(mesh)``, and returns the outputs
    stacked on the first entry's device."""
    core = l1_to_l2.make_core(plan, cfg, geom)

    def run(batch):
        lanes = lanes_of(mesh, batch)
        return run_stacked(mesh, lambda i, lane: core(lane), lanes)

    return run


def _core_identity(prep):
    """What decides a calibration core: MA table, static choices, geometry."""
    return repr((prep["read_pattern"], sorted(prep["cfg"].items()), prep["geom"]))


def calibrate_fpa(configs, mesh=None, write=True, max_workers=8, profile=False,
                  prefetch=1):
    """Calibrate a batch of SCAs (one ``calibrateimage`` config each)
    over the mesh.

    A host thread pool reads each L1 tree, its cal pack
    (:func:`..io.calfiles.load_caldir_cached`) and its pixel-area map.
    SCA ``i`` belongs to mesh entry ``i % len(mesh)``, which prepares
    and stages it (:func:`..pipeline.l1_to_l2.prepare_inputs`) only when
    its turn comes, with at most ``prefetch`` SCAs staged at a time,
    runs the single-SCA core, brings the outputs to the host and drops
    the staged bundle; the cal packs stay on each device as far as its
    byte budget holds them whole (:data:`..io.staging._DEVICE_CACHE`,
    shared with every other staging of the process: a card of 80 GB
    holds a focal plane's 18).  Mixed MA tables and options need
    nothing special: each SCA runs its own core.  Each tree is the
    ``calibrateimage`` tree of its config bit for bit, its log's
    ``Timing:`` line aside; ``write`` writes it to the config's OUT
    after ``typefix.fix``, as ``calibrateimage`` does.

    Returns the L2 trees; with ``profile=True`` ``(trees, timings)``:
    ``host_staging_s`` (until the pool has read every input),
    ``groups`` (per mesh entry: ``device``, ``n_sca``, ``pad`` 0,
    ``compute_s``), ``config_groups`` (distinct core identities),
    ``package_s``, ``write_s``, ``total_s`` and, on CUDA,
    ``peak_mem_gb``.
    """
    mesh = sca_mesh() if mesh is None else tuple(resolve_device(d) for d in mesh)
    n = len(configs)
    cuda_devs = {d for d in mesh if d.type == "cuda"}
    if cuda_devs:
        torch.cuda.init()  # the allocator's statistics exist only once CUDA is up
    for d in cuda_devs:
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    loaded_at = [t0] * n
    l1s, preps, outs = [None] * n, [None] * n, [None] * n

    def load_one(i):
        config = configs[i]
        pack = calfiles.load_caldir_cached(config["CALDIR"])
        l1 = asdf_lite.open(config["IN"])["roman"]
        area = l1_to_l2.area_factor_from_config(config, pack.nside)
        loaded_at[i] = time.perf_counter()
        return l1, pack, area

    with ThreadPoolExecutor(max_workers) as pool:
        loads = [pool.submit(load_one, i) for i in range(n)]

        def entry(e):
            dev = mesh[e]
            idxs = list(range(e, n, len(mesh)))
            slots = threading.Semaphore(prefetch)
            tc = time.perf_counter()

            def prepare(i):
                slots.acquire()
                l1, pack, area = loads[i].result()
                l1s[i] = l1
                t1 = time.perf_counter()
                with device_context(dev):
                    prep = l1_to_l2.prepare_inputs(l1, configs[i], pack, area, device=dev)
                return prep, time.perf_counter() - t1

            with device_context(dev), ThreadPoolExecutor(1) as stager:
                staged = [stager.submit(prepare, i) for i in idxs]
                try:
                    for i, fut in zip(idxs, staged):
                        prep, t_prep = fut.result()
                        t2 = time.perf_counter()
                        core = l1_to_l2.make_core(prep["plan"], prep["cfg"], prep["geom"])
                        outs[i] = l1_to_l2.to_host(core(prep.pop("arr")))
                        # calibrate_tree's log line, so the trees agree
                        prep["log"] += (
                            f"Timing: host prepare {1e3 * t_prep:.1f} ms; core "
                            f"device+transfer {1e3 * (time.perf_counter() - t2):.1f} ms "
                            f"on {dev}\n")
                        preps[i] = prep
                        del prep
                        slots.release()
                finally:
                    for f in staged:
                        f.cancel()
                    for _ in idxs:  # a stager waiting for a slot
                        slots.release()
            return {"device": str(dev), "n_sca": len(idxs), "pad": 0,
                    "compute_s": time.perf_counter() - tc}

        if len(mesh) == 1:
            groups = [entry(0)]
        else:
            with ThreadPoolExecutor(len(mesh)) as entries:
                groups = list(entries.map(entry, range(len(mesh))))

    timings = {"host_staging_s": max(loaded_at, default=t0) - t0, "groups": groups,
               "config_groups": len({_core_identity(p) for p in preps})}
    tp = time.perf_counter()
    trees = [l1_to_l2.package_tree(outs[i], preps[i], l1s[i], configs[i])
             for i in range(n)]
    timings["package_s"] = time.perf_counter() - tp

    if write:
        tw = time.perf_counter()

        def write_one(i):
            typefix.fix(trees[i])
            asdf_lite.AsdfFile(trees[i]).write_to(configs[i]["OUT"])

        with ThreadPoolExecutor(max_workers) as pool:
            list(pool.map(write_one, range(n)))
        timings["write_s"] = time.perf_counter() - tw
    timings["total_s"] = time.perf_counter() - t0
    if cuda_devs:
        timings["peak_mem_gb"] = max(torch.cuda.max_memory_allocated(d)
                                     for d in cuda_devs) / 1e9
    if profile:
        return trees, timings
    return trees


def make_fpa_exposure_runner(prep, pack, layers, mesh, config=None):
    """The production exposure (sim -> L1 fill -> L2 calibration -> noise
    layers) over the focal plane: the staged exposure runner with
    ``mesh`` (:func:`..pipeline.noise_core.make_staged_exposure_runner`).

    ``run(seed, batch)``: ``seed`` is one exposure seed; ``batch`` the
    :func:`..pipeline.noise_core.exposure_arrays` bundle with a leading
    SCA axis (:func:`broadcast_batch`, per-SCA rate maps stacked) or its
    :func:`shard_batch` lanes.  Lane ``i`` is the single-SCA runner at
    ``noise.lane_seed(seed, i)`` bit for bit.  Returns ``(cube (n_sca,
    nlayers, na, na), base dict, checksums (n_sca,))`` stacked on the
    first mesh entry's device.
    """
    from ..pipeline import noise_core

    return noise_core.make_staged_exposure_runner(prep, pack, layers, config=config,
                                                  mesh=mesh)


def fpa_summary(mesh, slopes):
    """Per-SCA mean and standard deviation (numpy) of a stack of slope
    maps (a tensor with a leading SCA axis, or a list of per-lane
    tensors on their mesh entries), each computed where its lane lies;
    ``mesh`` is taken for the JAX package's signature."""
    lanes = list(slopes)
    means = np.empty(len(lanes), np.float32)
    stds = np.empty(len(lanes), np.float32)
    for i, x in enumerate(lanes):
        x = torch.as_tensor(x)
        means[i] = float(x.mean(dim=(-2, -1)))
        stds[i] = float(x.std(dim=(-2, -1), correction=0))
    return means, stds
