"""Inputs of the benchmark, made from the seed: cal packs and L1 exposures.

A frozen copy of the port's detector model (``synth.synth_cal_arrays``
and ``synth.synth_l1_cube`` of ``romanimpreprocess_tpu_torch``, commit
30ea5db), extended for production-like inputs:

- linearity Legendre coefficients of the order the configuration states
  (6, as ``calib.characterize`` fits them), IPC kernels that vary from
  pixel to pixel, a bias-correction cube, hot and dead pixels in the
  mask and the dark DQ;
- a scene: the sky (``sky_e_per_s`` times the flat) and stars whose
  brightest saturate within the ramp, drawn read by read with Poisson
  noise; cosmic-ray hits at ``cr_rate_per_pix_s``, a fixed count per
  exposure; read noise per read; amp33 at the read file's level.

Everything is drawn on ``device`` with one ``torch.Generator`` per array
group, in a few large calls, and handed back as host numpy: the program
and the plain reference get the same arrays.  A seed fixes every value;
the sizes (the number of stars and hits, the shapes) are the same for
every seed, so seeds change the values and not the work.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

#: reference-pixel DQ bit and the pixel bits the mask and dark DQ carry
REFERENCE_PIXEL = 2**31
DEAD = 2**10
HOT = 2**11
WARM = 2**12


@dataclasses.dataclass
class Pack:
    """One SCA's calibration data in host numpy, with the field names of
    the port's ``io.calfiles.CalPack``."""

    dark_cube: np.ndarray
    dark_slope: np.ndarray
    dark_dq: Optional[np.ndarray] = None
    gain: Optional[np.ndarray] = None
    gain_dq: Optional[np.ndarray] = None
    read_sigma: Optional[np.ndarray] = None
    resetnoise: Optional[np.ndarray] = None
    u_pink: float = 0.0
    c_pink: float = 0.0
    amp33_valid: bool = False
    amp33_med: Optional[np.ndarray] = None
    amp33_std: Optional[np.ndarray] = None
    amp33_m_pink: float = 0.0
    amp33_ru_pink: float = 0.0
    ipc_kernel: Optional[np.ndarray] = None
    lin_coefs: Optional[np.ndarray] = None
    lin_smin: Optional[np.ndarray] = None
    lin_smax: Optional[np.ndarray] = None
    lin_sref: Optional[np.ndarray] = None
    lin_dq: Optional[np.ndarray] = None
    flat: Optional[np.ndarray] = None
    flat_dq: Optional[np.ndarray] = None
    biascorr: Optional[np.ndarray] = None
    biascorr_t0: float = 0.0
    mask_dq: Optional[np.ndarray] = None
    saturation: Optional[np.ndarray] = None
    saturation_dq: Optional[np.ndarray] = None
    dark_decay: dict = dataclasses.field(default_factory=dict)
    wfi18_transient: dict = dataclasses.field(default_factory=dict)

    @property
    def nside(self):
        return self.dark_slope.shape[-1]

    @property
    def nbytes(self):
        return sum(v.nbytes for v in vars(self).values() if isinstance(v, np.ndarray))


def reads_to_pattern(reads):
    """Flattened READS pair list -> MA read pattern: ``[0,1, 1,2, 2,4]``
    -> ``[[0], [1], [2, 3]]``."""
    return [list(range(int(reads[2 * j]), int(reads[2 * j + 1])))
            for j in range(len(reads) // 2)]


def generator(device, seed, *tags):
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` (any
    whole number) and the integer ``tags``."""
    words = [int(seed) & (2**64 - 1)] + [int(t) for t in tags]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state >> np.uint64(1)))
    return g


def _host(t):
    return t.cpu().numpy()


def _grid(n, device):
    y, x = torch.meshgrid(torch.arange(n, dtype=torch.float32, device=device),
                          torch.arange(n, dtype=torch.float32, device=device),
                          indexing="ij")
    return x, y


def _group_times(cfg):
    pattern = reads_to_pattern(cfg["READS"])
    return np.array([cfg["frame_time"] * np.mean(g) for g in pattern])


def make_pack(cfg, seed, sca, device):
    """The cal pack of SCA ``sca`` (host numpy)."""
    N, nb, cw = cfg["nside"], cfg["nborder"], cfg["channelwidth"]
    na = N - 2 * nb
    ngrp = len(cfg["READS"]) // 2
    order = cfg["legendre_order"]
    g = generator(device, seed, 1, sca)
    f32 = dict(dtype=torch.float32, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, **f32)

    def randn(*shape):
        return torch.randn(shape, generator=g, **f32)

    x, y = _grid(N, device)
    border = torch.ones((N, N), dtype=torch.bool, device=device)
    border[nb:N - nb, nb:N - nb] = False
    t = torch.tensor(_group_times(cfg), **f32)

    dark_slope = 0.005 * 10.0 ** randn(N, N)
    dark_slope[border] = 0.0
    bias = (13000.0 + 400.0 * (rand(1) - 0.5)
            + 200 * torch.cos(2 * np.pi * x / 256.0)
            + 100 * torch.sin(2 * np.pi * y / 256.0) ** 3)
    dark_cube = torch.clamp(bias[None] + dark_slope[None] * t[:, None, None], 0, 65535)
    gain = torch.clamp(1.5 + 0.03 * randn(N, N), 1.4, 1.6)

    K = torch.zeros((3, 3, na, na), **f32)
    jitter = 1.0 + 0.1 * (2 * rand(3, 3, na, na) - 1)
    K[0, 1] = K[2, 1] = 0.015
    K[1, 0] = K[1, 2] = 0.013
    K[0, 0] = K[2, 2] = K[0, 2] = K[2, 0] = 0.002
    K = K * jitter
    K[0, :, 0, :] = 0.0
    K[:, 0, :, 0] = 0.0
    K[-1, :, -1, :] = 0.0
    K[:, -1, :, -1] = 0.0
    K[1, 1] = 1.0 - K.sum(dim=(0, 1)) + K[1, 1]

    smin = torch.clamp(5000 + 500 * torch.cos((x + 3 * y) / 100.0), 0.5, 65534.5)
    smax = torch.clamp(56000 + 10000 * rand(N, N), 0.5, 65534.5)
    sref = smin + 300 + 100 * (x % 2)
    coefs = torch.zeros((order + 1, N, N), **f32)
    coefs[2] = 20 + 180 * rand(N, N)
    z = 2 * (sref - smin) / (smax - smin) - 1
    coefs[1] = (smax - smin) / 2.0 - 3 * coefs[2] * z
    coefs[0] = -coefs[1] * z - coefs[2] * (1.5 * z**2 - 0.5)
    for k in range(3, order + 1):
        # small higher orders, each a few DN at the ends of the range
        coefs[k] = (4.0 / k) * (2 * rand(N, N) - 1)

    flat = (0.95 + 0.1 * (x / N - 1) - 0.2 * (y / N * (1 - y / N))) * (1 + 0.01 * randn(N, N))

    def bad_pixels(share, bits):
        u = rand(N, N)
        out = torch.zeros((N, N), dtype=torch.int64, device=device)
        lo = 0.0
        for frac, bit in zip(share, bits):
            out |= torch.where((u >= lo) & (u < lo + frac), bit, 0)
            lo += frac
        return out

    mask = bad_pixels((2e-4, 3e-4, 1e-3), (DEAD, HOT, WARM)) | torch.where(
        border, REFERENCE_PIXEL, 0)
    dark_dq = bad_pixels((3e-4,), (HOT,))

    def u32(t):
        return _host(t).astype(np.uint32)

    return Pack(
        dark_cube=_host(dark_cube),
        dark_slope=_host(dark_slope),
        dark_dq=u32(dark_dq),
        gain=_host(gain),
        read_sigma=_host(6.0 + 5.0 * rand(N, N)),
        u_pink=0.4, c_pink=0.8,
        amp33_valid=True,
        amp33_med=np.full((N, cw), 29000.0, np.float32),
        amp33_std=np.full((N, cw), 5.0, np.float32),
        amp33_m_pink=0.8, amp33_ru_pink=1.0,
        ipc_kernel=_host(K),
        lin_coefs=_host(coefs),
        lin_smin=_host(smin),
        lin_smax=_host(smax),
        lin_sref=_host(sref),
        lin_dq=np.zeros((N, N), np.uint32),
        flat=_host(flat),
        biascorr=_host(2.0 * randn(ngrp, na, na)),
        mask_dq=u32(mask),
        saturation=_host(torch.clamp(smax - 50, min=1.5)),
        saturation_dq=np.zeros((N, N), np.uint32),
    )


def _scene(cfg, pack, g, device):
    """Electron rate (e/s) on the active region: sky times the flat and
    Gaussian stars, log-uniform in flux, the brightest saturating."""
    N, nb = cfg["nside"], cfg["nborder"]
    na = N - 2 * nb
    f32 = dict(dtype=torch.float32, device=device)
    nstars = max(1, round(cfg["stars_per_sca"] * (na / 4088.0) ** 2))
    pos = torch.randint(0, na * na, (nstars,), generator=g, device=device)
    lo, hi = np.log(cfg["star_flux_e_per_s"][0]), np.log(cfg["star_flux_e_per_s"][1])
    flux = torch.exp(lo + (hi - lo) * torch.rand((nstars,), generator=g, **f32))
    point = torch.zeros(na * na, **f32)
    point.index_put_((pos,), flux, accumulate=True)
    r = 4
    d = torch.arange(-r, r + 1, **f32)
    psf1 = torch.exp(-0.5 * (d / cfg["psf_sigma_pix"]) ** 2)
    psf = psf1[:, None] * psf1[None, :]
    psf = psf / psf.sum()
    stars = torch.nn.functional.conv2d(point.view(1, 1, na, na), psf[None, None],
                                       padding=r)[0, 0]
    flat = torch.from_numpy(pack.flat[nb:N - nb, nb:N - nb]).to(device)
    return cfg["sky_e_per_s"] * flat + stars


def make_l1(cfg, pack, seed, sca, exposure, device):
    """One exposure of SCA ``sca`` as an in-memory L1 tree: uint16 ``data``
    (ngrp, N, N) and ``amp33`` (ngrp, N, channelwidth) with the exposure
    meta, drawn read by read against ``pack``."""
    N, nb, cw = cfg["nside"], cfg["nborder"], cfg["channelwidth"]
    na = N - 2 * nb
    ft = cfg["frame_time"]
    pattern = reads_to_pattern(cfg["READS"])
    ngrp = len(pattern)
    g = generator(device, seed, 2, sca, exposure)
    f32 = dict(dtype=torch.float32, device=device)
    act = (slice(nb, N - nb), slice(nb, N - nb))

    rate = _scene(cfg, pack, g, device)
    gain = torch.from_numpy(pack.gain).to(device)
    sigma = torch.from_numpy(pack.read_sigma).to(device)
    dark = torch.from_numpy(pack.dark_slope).to(device)
    bias = torch.from_numpy(pack.dark_cube[0]).to(device) - dark * float(_group_times(cfg)[0])
    full = torch.from_numpy(pack.lin_smax).to(device)

    # cosmic rays: a fixed count, uniform in pixel and time, charge
    # log-uniform over 100-5000 e
    nread = pattern[-1][-1] + 1
    texp = ft * (nread - 1)
    nhit = round(cfg["cr_rate_per_pix_s"] * na * na * texp)
    hit_pix = torch.randint(0, na * na, (nhit,), generator=g, device=device)
    hit_t = texp * torch.rand((nhit,), generator=g, **f32)
    hit_q = torch.exp(np.log(100.0) + np.log(50.0) * torch.rand((nhit,), generator=g, **f32))

    charge = torch.zeros((na, na), **f32)
    cube = torch.zeros((ngrp, N, N), **f32)
    group_of = {r: j for j, grp in enumerate(pattern) for r in grp}
    for r in range(nread):
        if r > 0:
            charge += torch.poisson(rate * ft, generator=g)
            new = (hit_t > ft * (r - 1)) & (hit_t <= ft * r)
            charge.view(-1).index_put_((hit_pix[new],), hit_q[new], accumulate=True)
        if r not in group_of:
            continue
        dn = bias + dark * (ft * r) + sigma * torch.randn((N, N), generator=g, **f32)
        dn[act] += charge / gain[act]
        cube[group_of[r]] += torch.minimum(dn, full)
    for j, grp in enumerate(pattern):
        cube[j] /= len(grp)
    data = torch.clamp(torch.round(cube), 0, 65535).to(torch.int32)
    amp33 = torch.clamp(torch.round(29000.0 + 4.0 * torch.randn((ngrp, N, cw), generator=g,
                                                                **f32)), 0, 65535)
    return {
        "meta": {
            "exposure": {
                "read_pattern": pattern,
                "frame_time": float(ft),
                "nresultants": ngrp,
                "exposure_time": float(texp),
            },
            "instrument": {"detector": f"WFI{sca + 1:02d}", "optical_element": "F184"},
            "pointing": dict(zip(("ra", "dec", "pa"), pointing(seed, exposure))),
        },
        "data": _host(data).astype(np.uint16),
        "amp33": _host(amp33.to(torch.int32)).astype(np.uint16),
    }


def pointing(seed, exposure):
    """(ra, dec, pa) in degrees of exposure ``exposure``."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 3, exposure])
    return (float(rng.uniform(0, 360)), float(rng.uniform(-60, -20)),
            float(rng.uniform(0, 360)))
