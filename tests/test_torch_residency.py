"""Cal packs held on the device under a byte budget
(``io.staging._DEVICE_CACHE``, a ``utils.hostcache.PackCache``): three
packs at 64^2 on the CPU with a budget that holds two, through
``prepare_inputs`` and ``calibrate_tree``.  A cyclic rotation keeps the
two that fit and hits on them every round; a pack evicted and staged
again gives the same outputs bit for bit; the pack counters and gauge
come out exact; ``clear()`` through each name the benchmark clears
releases every resident byte."""

import gc
import weakref

import numpy as np
import pytest
import torch

from romanimpreprocess_tpu_torch import synth
from romanimpreprocess_tpu_torch.io import asdf_lite, calfiles, staging
from romanimpreprocess_tpu_torch.ops import ipc_cuda
from romanimpreprocess_tpu_torch.pipeline import l1_to_l2
from romanimpreprocess_tpu_torch.utils import hostcache, profiling

torch.set_num_threads(1)

N = 64
NB = 4
RP = synth.READ_PATTERN_DEFAULT
#: the cal-pack arrays ``prepare_inputs`` holds on the device (the IPC
#: kernel is read by the precal only, and not kept)
HELD = ("amp33_med", "dark_cube", "dark_slope", "dark_dq", "gain", "read_sigma", "mask_dq",
        "saturation", "saturation_dq", "biascorr", "lin_coefs", "lin_smin", "lin_smax",
        "lin_sref", "lin_dq", "flat")
#: the names the benchmark's entry clears before its reference runs
CLEARED = ((l1_to_l2, "_DEVICE_CACHE"), (l1_to_l2, "_IPC_PRECAL_CACHE"),
           (ipc_cuda, "_PLANES_CACHE"))


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    """Three SCAs, each its own cal pack and L1 exposure."""
    d = tmp_path_factory.mktemp("residency")
    out = []
    for i in range(3):
        caldir = synth.make_cal_files(str(d / f"cal{i}"), RP, nside=N, seed=5 + i)
        cal = synth.synth_cal_arrays(N, RP, seed=5 + i)
        path = str(d / f"L1_{i}.asdf")
        synth.write_l1_file(path, synth.synth_l1_cube(cal, RP, seed=7 + i, rate_dn_s=10,
                                                      nborder=NB), RP,
                            amp33=synth.synth_amp33(N, len(RP), 4, seed=11 + i))
        out.append((asdf_lite.open(path)["roman"],
                    {"IN": path, "CALDIR": caldir, "SKYORDER": 2, "SLICEOUT": True},
                    calfiles.load_caldir(caldir)))
    return out


def _device_bytes(pack):
    """Bytes one pack holds on the device: its arrays (4 bytes a value
    there), the IPC precal pair and the nine kernel planes."""
    na = N - 2 * NB
    arrays = sum(4 * np.size(getattr(pack, k)) for k in HELD if getattr(pack, k) is not None)
    return arrays + 2 * 4 * na * na + 9 * 4 * N * N


def _staged_bytes(pack):
    """Bytes one miss copies: the arrays in their wire formats, the
    precal's pair, its gain planes and the IPC kernel, the planes."""
    na = N - 2 * NB
    arrays = sum(staging.from_host(getattr(pack, k)).nbytes for k in HELD
                 if getattr(pack, k) is not None)
    return (arrays + 4 * na * na * (2 + 1 + 1) + staging.from_host(pack.ipc_kernel).nbytes
            + 9 * 4 * N * N)


@pytest.fixture
def two_fit(three, monkeypatch):
    """The device cache emptied, with a budget of two and a half packs."""
    cache = staging._DEVICE_CACHE
    cache.clear()
    one = _device_bytes(three[0][2])
    assert all(_device_bytes(p) == one for _, _, p in three)
    monkeypatch.setattr(cache, "_budget", 2 * one + one // 2)
    yield one
    cache.clear()


def _recording():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _prepare(three, i):
    l1, config, pack = three[i]
    return l1_to_l2.prepare_inputs(l1, config, pack, device="cpu")


def test_one_pack_holds_what_it_stages(three, two_fit):
    """One lookup admits the pack whole: its arrays, precal and planes,
    counted to the byte."""
    profiling.reset()
    with _recording():
        _prepare(three, 0)
    snap = profiling.snapshot()
    assert snap["counters"]["pack_misses"] == 1 and "pack_hits" not in snap["counters"]
    assert snap["counters"]["pack_staged_bytes"] == _staged_bytes(three[0][2])
    assert staging._DEVICE_CACHE.resident_bytes == two_fit
    assert snap["gauges"]["pack_resident_bytes"] == two_fit
    held = [k for k in HELD if getattr(three[0][2], k) is not None]
    assert len(staging._DEVICE_CACHE) == len(held) + 2  # the arrays, precal, planes


def test_a_cyclic_rotation_hits_on_the_packs_that_fit(three, two_fit):
    """Three packs in turn, two fit: after the first round two calls of
    every three hit, and nothing is evicted (evict-oldest would hit on
    none)."""
    profiling.reset()
    hits = []
    with _recording():
        for i in [0, 1, 2] * 4:
            before = profiling.snapshot()["counters"].get("pack_hits", 0)
            _prepare(three, i)
            hits.append(profiling.snapshot()["counters"].get("pack_hits", 0) - before)
    assert hits == [0, 0, 0] + [1, 1, 0] * 3
    snap = profiling.snapshot()
    c = snap["counters"]
    assert c["pack_misses"] == 6 and c["pack_hits"] == 6
    assert c.get("pack_evictions", 0) == 0 and "host.pack_evict" not in snap["spans"]
    assert c["pack_staged_bytes"] == 6 * _staged_bytes(three[0][2])
    assert snap["gauges"]["pack_resident_bytes"] == 2 * two_fit
    assert staging._DEVICE_CACHE.resident_bytes == 2 * two_fit


def test_a_pack_evicted_and_staged_again_gives_the_same_outputs(three, two_fit):
    """A B C C A A A: C's second lookup evicts A, the least recently used
    pack not looked up since; A's first return is not admitted, its
    second evicts B, its third hits.  A's outputs are the same bit for
    bit, first staged, staged again for one call, resident again."""
    profiling.reset()
    outs = []
    with _recording():
        for i in (0, 1, 2, 2, 0, 0, 0):
            l1, config, pack = three[i]
            area = np.ones((N, N), np.float32)
            outs.append(l1_to_l2.calibrate_tree(l1, config, pack, area, device="cpu")[1])
    snap = profiling.snapshot()
    c = snap["counters"]
    assert (c["pack_misses"], c["pack_hits"], c["pack_evictions"]) == (6, 1, 2)
    assert snap["spans"]["host.pack_evict"]["count"] == 2
    assert c["pack_staged_bytes"] == 6 * _staged_bytes(three[0][2])
    assert snap["gauges"]["pack_resident_bytes"] == 2 * two_fit
    for again in (outs[4], outs[5], outs[6]):
        assert set(again) == set(outs[0])
        for k, v in outs[0].items():
            np.testing.assert_array_equal(again[k], v, err_msg=k)
    assert not np.array_equal(outs[0]["slope"], outs[2]["slope"])  # another pack


@pytest.mark.parametrize("mod,name", CLEARED, ids=[n for _, n in CLEARED])
def test_clear_through_each_name_releases_every_resident_byte(three, two_fit, mod, name):
    """Two packs resident; ``clear()`` through any of the three names
    drops them and their tensors, and sets the gauge to 0."""
    refs = []
    for i in (0, 1):
        arr = _prepare(three, i)["arr"]
        refs += [weakref.ref(arr[k]) for k in ("gain", "lin_coefs", "dark_slope_ipc",
                                              "flat_ipc", "ipc_kernel_frame")]
        del arr
    gc.collect()
    assert all(r() is not None for r in refs)  # held by the cache
    assert staging._DEVICE_CACHE.resident_bytes == 2 * two_fit
    profiling.reset()
    with _recording():
        getattr(mod, name).clear()
    gc.collect()
    assert staging._DEVICE_CACHE.resident_bytes == 0 and len(staging._DEVICE_CACHE) == 0
    assert all(r() is None for r in refs)
    assert profiling.snapshot()["gauges"] == {"pack_resident_bytes": 0}


# ---- the policy alone (hostcache.PackCache) ----


def _admit(cache, obj, entries, device="cpu"):
    held = cache.pack(obj, device)
    for key, nbytes in entries:
        if cache.get(key, pack=held) is None:
            cache.put(key, (key,), nbytes, device, pack=held)
    return cache.admit(held)


def test_a_pack_that_cannot_fit_is_not_resident_at_all():
    cache = hostcache.PackCache("test", budget=100)
    small, big = object(), object()
    assert not _admit(cache, small, [("a", 30), ("b", 30)])
    assert _admit(cache, small, [("a", 30), ("b", 30)])
    # a pack bigger than the budget stays out whole, and evicts nothing
    for _ in range(3):
        assert not _admit(cache, big, [("c", 60), ("d", 60)])
    assert cache.get("c") is None and cache.get("d") is None
    assert cache.resident_bytes == 60 and len(cache) == 2
    # growing a resident pack past the budget drops it whole
    assert not _admit(cache, small, [("a", 30), ("b", 30), ("e", 50)])
    assert cache.resident_bytes == 0 and len(cache) == 0


def test_loose_entries_count_toward_the_budget_and_go_first():
    cache = hostcache.PackCache("test", capacity=3, budget=100)
    for k in "xyz":
        cache.put(k, (k,), 20, "cpu")
    cache.put("w", ("w",), 20, "cpu")  # evict-oldest at capacity
    assert cache.get("x") is None and len(cache) == 3
    cache.put("v", ("v",), 90, "cpu")  # room made from the oldest loose ones
    assert [cache.get(k) is None for k in "yzwv"] == [True, True, True, False]
    # a pack's lookup takes a loose copy of its array into the pack
    p = object()
    assert not _admit(cache, p, [("v", 90)])
    assert cache.resident_bytes == 90 and len(cache) == 1
    assert _admit(cache, p, [("v", 90)])
    # and a pack makes room from loose entries of its device
    cache.clear()
    cache.put("u", ("u",), 50, "cpu")
    assert not _admit(cache, p, [("t", 80)])
    assert cache.get("u") is None and cache.resident_bytes == 80


def test_admission_follows_what_the_card_has_free():
    """With a budget of what the card has free less a reserve, a lookup
    keeps its pack only while the reserve stays free: a new pack is not
    admitted, a loose entry not kept, and a resident pack found whole
    leaves the cache where other work has taken the room."""
    free = {"cuda:0": 100}
    cache = hostcache.PackCache("test", budget=lambda dev, held: held + free[dev] - 10)
    a, b = object(), object()
    assert not _admit(cache, a, [("a", 30)], "cuda:0")
    assert cache.resident_bytes == 30
    free["cuda:0"] = 5  # other work holds the card
    assert not _admit(cache, b, [("b", 30)], "cuda:0")
    cache.put("x", ("x",), 1, "cuda:0")
    assert cache.get("b") is None and cache.get("x") is None and cache.resident_bytes == 30
    assert _admit(cache, a, [("a", 30)], "cuda:0")  # found whole, then dropped
    assert cache.resident_bytes == 0 and len(cache) == 0
    free["cuda:0"] = 100
    assert not _admit(cache, b, [("b", 30)], "cuda:0")
    assert cache.resident_bytes == 30


def test_card_budget_is_what_the_card_has_free_less_the_reserve(monkeypatch):
    """On a CUDA device the budget is what the cache holds, the driver's
    free memory and the allocator's unused blocks, less ``RESERVE``; on
    the CPU there is none."""
    assert staging.card_budget("cpu", 123) is None
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (40 * 2**30, 80 * 2**30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 9 * 2**30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 7 * 2**30)
    got = staging.card_budget("cuda:0", 5 * 2**30)
    assert got == (5 + 40 + 9 - 7) * 2**30 - staging.RESERVE
