"""CALDIR loading: calibration reference files -> structured arrays.

The reference opens each ASDF cal file ad hoc at every use site
(``gen_cal_image.py`` passim); here the CALDIR dict (the package's
CRDS substitute, README.rst:33-34) is loaded **once** into a
:class:`CalPack` of host numpy arrays which the pipeline stages onto the
device a single time per exposure batch.

File formats follow the reference spec exactly
(``docs/from_sim_README.rst:70-179``): dark (data cube + dark_slope),
gain, ipc4d, linearitylegendre (data/Smin/Smax/Sref/dq), read
(data/resetnoise/anc.U_PINK/C_PINK/amp33{med,std,M_PINK,RU_PINK}),
flat(pflat), biascorr (data + t0), mask (dq), saturation (data + dq),
optional dark_decay (decay_table per detector), optional
wfi18_transient (transient_table per detector: first-read row-profile
taus).
"""

import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import asdf_lite
from ..utils import hostcache


@dataclass
class CalPack:
    """All calibration reference data for one SCA (host numpy)."""

    # dark
    dark_cube: np.ndarray  # (ngrp_dark, ny, nx) DN
    dark_slope: np.ndarray  # (ny, nx) DN/s
    dark_dq: Optional[np.ndarray] = None
    # gain
    gain: Optional[np.ndarray] = None  # (ny, nx) e/DN
    gain_dq: Optional[np.ndarray] = None
    # read noise
    read_sigma: Optional[np.ndarray] = None  # (ny, nx) DN
    resetnoise: Optional[np.ndarray] = None  # (ny, nx) DN
    u_pink: float = 0.0
    c_pink: float = 0.0
    amp33_valid: bool = False
    amp33_med: Optional[np.ndarray] = None  # (ny, channelwidth)
    amp33_std: Optional[np.ndarray] = None
    amp33_m_pink: float = 0.0
    amp33_ru_pink: float = 0.0
    # IPC
    ipc_kernel: Optional[np.ndarray] = None  # (3, 3, na, na)
    # linearity
    lin_coefs: Optional[np.ndarray] = None  # (order+1, ny, nx)
    lin_smin: Optional[np.ndarray] = None
    lin_smax: Optional[np.ndarray] = None
    lin_sref: Optional[np.ndarray] = None
    lin_dq: Optional[np.ndarray] = None
    # flat
    flat: Optional[np.ndarray] = None  # (ny, nx) pflat
    flat_dq: Optional[np.ndarray] = None
    # bias correction
    biascorr: Optional[np.ndarray] = None  # (ngrp_b, na, na) DN
    biascorr_t0: float = 0.0
    # mask
    mask_dq: Optional[np.ndarray] = None  # (ny, nx) uint32
    # saturation
    saturation: Optional[np.ndarray] = None  # (ny, nx) DN
    saturation_dq: Optional[np.ndarray] = None
    # dark decay (per-detector table)
    dark_decay: dict = field(default_factory=dict)
    # first-read row transient (per-detector taus; reference applies
    # romancal's WFI18 anomaly correction, gen_cal_image.py:327-353)
    wfi18_transient: dict = field(default_factory=dict)

    @property
    def nside(self):
        return self.dark_slope.shape[-1]


def load_caldir(caldir):
    """Read a CALDIR dict of file paths into a CalPack."""
    pack = {}

    f = asdf_lite.open(caldir["dark"])["roman"]
    pack["dark_cube"] = np.asarray(f["data"], np.float32)
    pack["dark_slope"] = np.asarray(f["dark_slope"], np.float32)
    if "dq" in f:
        pack["dark_dq"] = np.asarray(f["dq"], np.uint32)

    if "gain" in caldir:
        f = asdf_lite.open(caldir["gain"])["roman"]
        pack["gain"] = np.asarray(f["data"], np.float32)
        if "dq" in f:
            pack["gain_dq"] = np.asarray(f["dq"], np.uint32)

    if "read" in caldir:
        f = asdf_lite.open(caldir["read"])["roman"]
        pack["read_sigma"] = np.asarray(f["data"], np.float32)
        if "resetnoise" in f:
            pack["resetnoise"] = np.asarray(f["resetnoise"], np.float32)
        if "anc" in f:
            pack["u_pink"] = float(f["anc"]["U_PINK"])
            pack["c_pink"] = float(f["anc"]["C_PINK"])
        if "amp33" in f and f["amp33"].get("valid", False):
            pack["amp33_valid"] = True
            pack["amp33_med"] = np.asarray(f["amp33"]["med"], np.float32)
            pack["amp33_std"] = np.asarray(f["amp33"]["std"], np.float32)
            pack["amp33_m_pink"] = float(f["amp33"]["M_PINK"])
            pack["amp33_ru_pink"] = float(f["amp33"]["RU_PINK"])

    if "ipc4d" in caldir:
        f = asdf_lite.open(caldir["ipc4d"])["roman"]
        pack["ipc_kernel"] = np.asarray(f["data"], np.float32)

    if "linearitylegendre" in caldir:
        f = asdf_lite.open(caldir["linearitylegendre"])["roman"]
        pack["lin_coefs"] = np.asarray(f["data"], np.float32)
        pack["lin_smin"] = np.asarray(f["Smin"], np.float32)
        pack["lin_smax"] = np.asarray(f["Smax"], np.float32)
        pack["lin_sref"] = np.asarray(f["Sref"], np.float32)
        pack["lin_dq"] = np.asarray(f["dq"], np.uint32)

    if "flat" in caldir:
        f = asdf_lite.open(caldir["flat"])["roman"]
        pack["flat"] = np.asarray(f["data"], np.float32)
        if "dq" in f:
            pack["flat_dq"] = np.asarray(f["dq"], np.uint32)

    if "biascorr" in caldir:
        f = asdf_lite.open(caldir["biascorr"])["roman"]
        pack["biascorr"] = np.asarray(f["data"], np.float32)
        pack["biascorr_t0"] = float(f["t0"])

    if "mask" in caldir:
        f = asdf_lite.open(caldir["mask"])["roman"]
        pack["mask_dq"] = np.asarray(f["dq"], np.uint32)

    if "saturation" in caldir:
        f = asdf_lite.open(caldir["saturation"])["roman"]
        pack["saturation"] = np.asarray(f["data"], np.float32)
        if "dq" in f:
            pack["saturation_dq"] = np.asarray(f["dq"], np.uint32)

    if "dark_decay" in caldir:
        f = asdf_lite.open(caldir["dark_decay"])["roman"]
        pack["dark_decay"] = {
            k: {
                "amplitude": float(v["amplitude"]),
                "time_constant": float(v["time_constant"]),
            }
            for k, v in f["decay_table"].items()
        }

    if "wfi18_transient" in caldir:
        f = asdf_lite.open(caldir["wfi18_transient"])["roman"]
        pack["wfi18_transient"] = {
            k: {"taus": tuple(float(t) for t in v["taus"])}
            for k, v in f["transient_table"].items()
        }

    return CalPack(**pack)


_PACK_CACHE = hostcache.BoundedCache(40, "cal_packs")
# one lock per CALDIR key: pool threads asking for the same CALDIR at
# once get one pack (one set of array ids, so one device copy)
_KEY_LOCKS = {}
_KEY_LOCKS_LOCK = threading.Lock()


def load_caldir_cached(caldir, max_entries=40):
    """Cache CalPacks by their file-path set.

    Batch runs reuse one SCA's calibration across every exposure
    (reference: re-opened per use site); the cache loads each CALDIR
    once per process.  Capacity must cover an --sca=all sweep's WHOLE
    working set — 18 sim-side (c1) + 18 calibration-side (c2) distinct
    CALDIR dicts = 36 keys; a smaller cap makes each exposure evict the
    other stage's packs, re-reading ~GB of cal ASDF per exposure and
    (new array ids) missing the id-keyed ipc_precal cache.
    """
    key = tuple(sorted((k, str(v)) for k, v in caldir.items()))
    with _KEY_LOCKS_LOCK:
        lock = _KEY_LOCKS.setdefault(key, threading.Lock())
    with lock:
        hit = _PACK_CACHE.get(key)
        if hit is not None:
            return hit
        pack = load_caldir(caldir)
        _PACK_CACHE.capacity = int(max_entries)
        return _PACK_CACHE.put(key, pack)


def amp33_optimal_slope(pack):
    """Optimal row-reference coupling slope from the pink-noise model.

    Reference: ``gen_cal_image.py:542-553``.  Returns None when no
    amp33 information is available.
    """
    if not pack.amp33_valid:
        return None
    cvar = pack.c_pink**2
    m = pack.amp33_m_pink
    nside = pack.amp33_med.shape[0]
    cw = pack.amp33_med.shape[1]
    return float(
        m * cvar
        / (
            m * m * cvar
            + pack.amp33_ru_pink**2
            + np.median(pack.amp33_std) ** 2 / cw / np.log(nside)
        )
    )
