"""The entry ``l1_to_l2_wcs``: production's ``calibrateimage`` call with
its per-exposure WCS, the sidecar -> the pixel-area map -> the L2
calibration::

    area = l1_to_l2.area_factor_from_config(config, nside, device=...)
    tree, _ = l1_to_l2.calibrate_tree(l1, config, pack, area, device=...)
    typefix.fix(tree)

over the mix's pointings in turn (ASDF I/O left out, as in
:mod:`.l1_to_l2`, whose code this entry reuses).  Pointing ``k``
calibrates exposure ``k mod exposures``'s L1 cube under its own WCS
solution: that exposure's pointing dithered by ``dither_deg``, the
SCA's TAN-SIP header (:func:`..wcsarea.header`) with its plate scale
times ``1 + U(-wcs_scale_jitter, wcs_scale_jitter)`` and each SIP term
times ``1 + N(0, wcs_sip_sigma)``, all drawn from the seed.  A TAN-SIP
pixel's solid angle does not depend on CRVAL or the roll, so without
the scale and SIP draws every pointing would give one map.  Each
pointing's sidecar is written under the run's work directory at set-up;
none repeats within the mix.

The program's map is kept beside its tree (``area_factor``); the
reference (:mod:`..reference.l2`) calibrates with the frozen map of the
pointing's cards (:func:`..wcsarea.area_factor`, float64), the control
with the same arithmetic in float32 (:func:`area_factor_lowered`) and
the reference's float32 products in TF32.  :func:`numbers` adds to
:func:`..compare.numbers` ``area_gap``, the largest ``|a_p - a_r| /
a_r`` over the map's pixels.
"""

import numpy as np
import torch

from gpubench import compare, gen, spec, wcsarea
from gpubench.reference import l2 as reference
from gpubench.reference import sky as ref_sky

base = spec.entry("l1_to_l2")

RANGES = base.RANGES
check = base.check
load = base.load

#: the WCS solution's plate-scale terms
CD_KEYS = ("CD1_1", "CD1_2", "CD2_1", "CD2_2")


def is_sip(key):
    """Whether the card ``key`` is a SIP coefficient (``A_p_q``, ``B_p_q``)."""
    parts = key.split("_")
    return len(parts) == 3 and parts[0] in ("A", "B") and parts[1].isdigit()


def pointing_cards(cfg, seed, k, exposures):
    """(exposure, (ra, dec, pa), WCS cards) of pointing ``k``."""
    e = k % exposures
    ra, dec, pa = gen.pointing(seed, e)
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 7, k])
    d = cfg["dither_deg"]
    dra, ddec = rng.uniform(-d, d, 2)
    dec = dec + ddec
    ra = (ra + dra / np.cos(np.radians(dec))) % 360.0
    cards = wcsarea.header(seed, 0, e, ra, dec, pa, cfg["nside"], cfg["nborder"])
    j = cfg["wcs_scale_jitter"]
    scale = 1.0 + rng.uniform(-j, j)
    for key in CD_KEYS:
        cards[key] *= scale
    for key in [key for key in cards if is_sip(key)]:
        cards[key] *= 1.0 + rng.normal(0.0, cfg["wcs_sip_sigma"])
    return e, (float(ra), float(dec), float(pa)), as_written(cards)


def as_written(cards):
    """``cards`` with the values that the sidecar holds
    (:func:`..wcsarea.write_sidecar`: floats to 14 digits), which the
    program reads back."""
    return {key: float(f"{v:.13E}") if isinstance(v, float) else v for key, v in cards.items()}


def area_factor_lowered(cards, nside, device):
    """:func:`..wcsarea.area_factor`'s arithmetic one precision below the
    configuration's float64: in float32."""
    N = nside
    sp = torch.linspace(-1, N, N + 2, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(sp, sp, indexing="ij")
    ra, dec = wcsarea._pix2world(cards, xx.reshape(-1), yy.reshape(-1))
    theta = np.pi / 2.0 + dec
    if float(dec[0]) > 0:
        theta = np.pi / 2.0 - dec
    rho = 2.0 * torch.sin(theta / 2.0)
    u = (rho * torch.cos(ra)).reshape(N + 2, N + 2)
    v = (rho * torch.sin(ra)).reshape(N + 2, N + 2)
    J11 = (u[1:-1, 2:] - u[1:-1, :-2]) / 2.0
    J12 = (u[2:, 1:-1] - u[:-2, 1:-1]) / 2.0
    J21 = (v[1:-1, 2:] - v[1:-1, :-2]) / 2.0
    J22 = (v[2:, 1:-1] - v[:-2, 1:-1]) / 2.0
    area = torch.abs(J11 * J22 - J21 * J12)
    return (area / np.float32(wcsarea.OMEGA_IDEAL)).to(torch.float32).cpu().numpy()


def area_gap(p, r, device="cpu"):
    """The largest ``|p - r| / r`` over the pixels of two area maps
    (tensors or arrays); infinite where the shapes differ or a value is
    not finite on either side."""
    p = torch.as_tensor(p).to(device, torch.float64)
    r = torch.as_tensor(np.asarray(r)).to(device, torch.float64)
    if p.shape != r.shape or not bool(torch.isfinite(p).all() & torch.isfinite(r).all()):
        return float("inf")
    return float(((p - r).abs() / r.abs()).max())


class Entry(base.Entry):
    """The pointings' inputs, made from the seed at set-up, and the call."""

    def __init__(self, cfg, mix, seed, device, workdir):
        self.l1_to_l2, self.ipc_cuda, typefix = load()
        self.fix = typefix.fix
        self._typefix = typefix
        self.cfg, self.device = cfg, device
        nexp = self.exposures = mix["exposures"]
        self.packs = [gen.make_pack(cfg, seed, 0, device)]
        cubes = [gen.make_l1(cfg, self.packs[0], seed, 0, e, device) for e in range(nexp)]
        workdir.mkdir(parents=True, exist_ok=True)
        self.items = list(range(mix["pointings"]))
        self.l1, self.cards, self.config = {}, {}, {}
        for k in self.items:
            e, (ra, dec, pa), cards = pointing_cards(cfg, seed, k, nexp)
            sidecar = workdir / f"sim_L1_F184_{k}_1_asdf_wcshead.txt"
            wcsarea.write_sidecar(sidecar, cards)
            l1 = cubes[e]
            self.l1[k] = dict(l1, meta=dict(l1["meta"], pointing=dict(ra=ra, dec=dec, pa=pa)))
            self.cards[k] = cards
            self.config[k] = base.program_config(cfg, 0, e, sidecar)
        self.shapes = dict(ngrp=len(cfg["READS"]) // 2, nside=cfg["nside"],
                           ncoef=cfg["legendre_order"] + 1)

    def describe(self):
        return (f"1 pack of {self.packs[0].nbytes / 1e9:.3f} GB, "
                f"{self.exposures} L1 exposures, "
                f"{len(self.items)} pointings with their sidecars")

    def args(self, item):
        return self.l1[item], self.config[item], self.packs[0]

    def call(self, item):
        """One call on pointing ``item``: the program's L2 tree, with the
        area map it used as ``area_factor``."""
        l1, config, pack = self.args(item)
        area = self.l1_to_l2.area_factor_from_config(config, pack.nside, device=self.device)
        tree, _ = self.l1_to_l2.calibrate_tree(l1, config, pack, area, device=self.device)
        self.fix(tree)
        return dict(tree, area_factor=area)

    def install_spans(self, spans):
        """The :mod:`.l1_to_l2` entry's spans, and ``area_factor_from_config``."""
        super().install_spans(spans)
        spans.install([(self.l1_to_l2, "area_factor_from_config")])

    def reference(self, item):
        """The reference's L2 arrays for ``item``, with the frozen map."""
        area = wcsarea.area_factor(self.cards[item], self.cfg["nside"], self.device)
        return dict(reference.calibrate(*self.args(item), area, self.device), area_factor=area)

    def control(self, item):
        """The reference one precision below the configuration's: the map
        in float32 arithmetic, the float32 products in TF32 and the ramp
        fit's cube in bfloat16; as an L2 tree with its map."""
        with ref_sky.lowered_precision():
            area = area_factor_lowered(self.cards[item], self.cfg["nside"], self.device)
            tree = base.as_tree(reference.calibrate(*self.args(item), area, self.device))
        return dict(tree, area_factor=area)

    def numbers(self, tree, ref):
        """:func:`..compare.numbers` and ``area_gap``."""
        out = compare.numbers(tree, ref, self.device)
        out["area_gap"] = area_gap(tree["area_factor"], ref["area_factor"], self.device)
        return out
