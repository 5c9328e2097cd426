"""The entry ``l1_to_l2``: one SCA's L1 -> L2 calibration.

What ``calibrateimage`` does between its ASDF read and its ASDF write::

    tree, _ = l1_to_l2.calibrate_tree(l1, config, pack, area_factor, device=...)
    typefix.fix(tree)

over the mix's sequence of (SCA, exposure) pairs: exposure after
exposure, each the mix's SCAs in focal-plane order.  Each pair has its
own L1 tree, WCS sidecar (written under the run's work directory) and
pixel-area map; each SCA its own cal pack.  The area map is computed at
set-up (:mod:`..wcsarea`), the one step of ``calibrateimage`` left out
of the call; ASDF I/O is left out.  Production reads each exposure's
sidecar once, so each call gives its sidecar a new modification time:
the program's sidecar cache, keyed by path and time, misses as it does
there.

The configuration file's ``program`` object is the program's config
dict, passed whole, with the files each call names (``IN``, ``OUT``,
``FITSWCS``, ``CALDIR``); :func:`check` refuses a key that the plain
reference (:mod:`..reference.l2`) does not honour.  The other keys of
the file size the inputs (:mod:`..gen`).
"""

import gc
import os

import torch

from gpubench import compare, gen, wcsarea
from gpubench.reference import l2 as reference
from gpubench.reference import sky as ref_sky

#: the program's device-stage ranges start with this
RANGES = "l1_to_l2."
#: the files a call names, which the entry writes into the program's config
CALL_KEYS = ("IN", "OUT", "FITSWCS", "CALDIR")


def check(cfg):
    """ValueError where the configuration's ``program`` object holds a key
    that the reference does not honour, or one that each call sets."""
    prog = cfg["program"]
    bad = reference.unhonoured(prog) + sorted(set(prog) & set(CALL_KEYS))
    if bad:
        raise ValueError(f"configuration keys the benchmark cannot hold the program to: {bad}")


def load():
    """The program's modules that a call goes through."""
    from romanimpreprocess_tpu_torch.ops import ipc_cuda
    from romanimpreprocess_tpu_torch.pipeline import l1_to_l2
    from romanimpreprocess_tpu_torch.utils import typefix

    return l1_to_l2, ipc_cuda, typefix


def program_config(cfg, sca, exposure, sidecar):
    """The config dict the program gets for one call."""
    c = dict(cfg["program"])
    stem = f"F184_{exposure}_{sca + 1}"
    c["IN"] = f"L1/sim_L1_{stem}.asdf"
    c["OUT"] = f"L2/sim_L2_{stem}.asdf"
    c["FITSWCS"] = str(sidecar)
    c["CALDIR"] = {k: f"cal/roman_wfi_{k}_SCA{sca + 1:02d}.asdf" for k in cfg["CALDIR"]}
    return c


def as_tree(arrays):
    """The reference's arrays in the shape of an L2 tree."""
    pi = {k: arrays[k] for k in ("medsky", "skycoefs", "endslice") if k in arrays}
    return {"roman": {k: v for k, v in arrays.items() if k not in pi}, "processinfo": pi}


class Entry:
    """Everything a cell's calls read, made from the seed at set-up, and
    the call itself."""

    def __init__(self, cfg, mix, seed, device, workdir):
        self.l1_to_l2, self.ipc_cuda, typefix = load()
        self.fix = typefix.fix
        self._typefix = typefix
        self.cfg, self.device = cfg, device
        self.items = [(s, e) for e in range(mix["exposures"]) for s in range(mix["scas"])]
        self.packs = [gen.make_pack(cfg, seed, s, device) for s in range(mix["scas"])]
        workdir.mkdir(parents=True, exist_ok=True)
        self.l1, self.area, self.config = {}, {}, {}
        for s, e in self.items:
            l1 = gen.make_l1(cfg, self.packs[s], seed, s, e, device)
            p = l1["meta"]["pointing"]
            cards = wcsarea.header(seed, s, e, p["ra"], p["dec"], p["pa"], cfg["nside"],
                                   cfg["nborder"])
            sidecar = workdir / f"sim_L1_F184_{e}_{s + 1}_asdf_wcshead.txt"
            wcsarea.write_sidecar(sidecar, cards)
            self.l1[s, e] = l1
            self.area[s, e] = wcsarea.area_factor(cards, cfg["nside"], device)
            self.config[s, e] = program_config(cfg, s, e, sidecar)
        self._mtime = int(os.stat(workdir).st_mtime_ns)
        self.shapes = dict(ngrp=len(cfg["READS"]) // 2, nside=cfg["nside"],
                           ncoef=cfg["legendre_order"] + 1)

    def describe(self):
        return (f"{len(self.packs)} packs of {self.packs[0].nbytes / 1e9:.3f} GB, "
                f"{len(self.items)} exposures")

    def args(self, item):
        s, _ = item
        return self.l1[item], self.config[item], self.packs[s], self.area[item]

    def call(self, item):
        """One call of the entry on ``item``: the program's L2 tree."""
        l1, config, pack, area = self.args(item)
        self._mtime += 1_000_000  # a millisecond: getmtime's float tells it apart
        os.utime(config["FITSWCS"], ns=(self._mtime, self._mtime))
        tree, _ = self.l1_to_l2.calibrate_tree(l1, config, pack, area, device=self.device)
        self.fix(tree)
        return tree

    def install_spans(self, spans):
        """Wrap the host driver's and staging's functions in ``spans``:
        staging (``stage``, ``ipc_precal``, ``kernel_planes_frame``) is
        one group, and its time inside ``prepare_inputs`` is kept."""
        spans.groups.update(stage="staging", ipc_precal="staging",
                            kernel_planes_frame="staging")
        spans.inside = "prepare_inputs"
        m = self.l1_to_l2
        spans.install([(m, "prepare_inputs"), (m, "to_host"), (m, "package_tree"),
                       (m, "stage"), (m, "ipc_precal"), (self.ipc_cuda, "kernel_planes_frame")])
        self.fix = spans.wrap("typefix.fix", self._typefix.fix)

    def free(self):
        """Drop the program's device and host caches before the reference
        runs."""
        for mod, name in ((self.l1_to_l2, "_DEVICE_CACHE"), (self.l1_to_l2, "_IPC_PRECAL_CACHE"),
                          (self.ipc_cuda, "_PLANES_CACHE")):
            cache = getattr(mod, name, None)
            if cache is not None and hasattr(cache, "clear"):
                cache.clear()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, item):
        """The reference's L2 arrays for ``item``."""
        return reference.calibrate(*self.args(item), self.device)

    def control(self, item):
        """The reference one precision below the configuration's (float32
        matrix products in TF32, the ramp fit's cube in bfloat16), as an
        L2 tree."""
        with ref_sky.lowered_precision():
            return as_tree(reference.calibrate(*self.args(item), self.device))

    def numbers(self, tree, ref):
        """The compared numbers of one call."""
        return compare.numbers(tree, ref, self.device)
