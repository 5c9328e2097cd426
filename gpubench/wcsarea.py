"""The per-exposure WCS sidecar and its pixel-area map.

Production writes, for each exposure and SCA, a FITS-card text file
beside the L1 (``<L1>_asdf_wcshead.txt``), which ``calibrateimage``
reads twice: ``area_factor_from_config`` turns it into the pixel-area
map that divides the flat, and ``package_tree`` embeds it as
``wcsinfo``.  :func:`header` makes one from the seed (a TAN-SIP header
of the science frame, 0-based CRPIX, third-order SIP distortion of the
SCA) and :func:`write_sidecar` writes it as 80-character cards.

:func:`area_factor` is a frozen copy, in PyTorch float64 on the device,
of the port's ``ops.wcsutils.pixelarea`` arithmetic (commit 30ea5db):
the equal-area azimuthal reprojection and the central-difference
Jacobian over the (N + 2)^2 pixel grid, divided by the ideal pixel
solid angle.  The port's NumPy form takes tens of seconds at 4096^2 on
a host CPU, so the benchmark computes the map at set-up and hands it
to ``calibrate_tree``, as ``calibrateimage`` does after reading the
sidecar.
"""

import numpy as np
import torch

#: (0.11 arcsec)^2 in steradians (the port's ``pars.Omega_ideal``)
OMEGA_IDEAL = 2.8440360952308436e-13
PIXSCALE_DEG = 0.11 / 3600.0


def header(seed, sca, exposure, ra, dec, pa, nside, nborder):
    """FITS cards (dict) of SCA ``sca`` in one exposure: 0-based CRPIX at
    the active region's centre, the pointing's CRVAL and roll, the
    SCA's own second- and third-order SIP terms."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 4, sca])
    na = nside - 2 * nborder
    c, s = np.cos(np.radians(pa)), np.sin(np.radians(pa))
    # an SCA's offset from the boresight, folded into its CRVAL
    dra, ddec = rng.uniform(-0.4, 0.4, 2)
    cards = {
        "CTYPE1": "RA---TAN-SIP",
        "CTYPE2": "DEC--TAN-SIP",
        "CRPIX1": (na - 1) / 2.0,
        "CRPIX2": (na - 1) / 2.0,
        "CRVAL1": float((ra + dra / max(np.cos(np.radians(dec)), 0.1)) % 360.0),
        "CRVAL2": float(dec + ddec),
        "CD1_1": -PIXSCALE_DEG * c,
        "CD1_2": PIXSCALE_DEG * s,
        "CD2_1": PIXSCALE_DEG * s,
        "CD2_2": PIXSCALE_DEG * c,
        "LONPOLE": 180.0,
        "A_ORDER": 3,
        "B_ORDER": 3,
    }
    for prefix in ("A", "B"):
        for p in range(4):
            for q in range(4 - p):
                if p + q >= 2:
                    scale = 2e-7 if p + q == 2 else 5e-11
                    cards[f"{prefix}_{p}_{q}"] = float(rng.normal(0.0, scale))
    return cards


def _card(key, value):
    if isinstance(value, str):
        v = f"'{value:<8s}'"
        return f"{key:<8s}= {v:<20s}"[:80].ljust(80)
    if isinstance(value, (int, np.integer)):
        return f"{key:<8s}= {int(value):>20d}".ljust(80)
    return f"{key:<8s}= {float(value):>20.13E}".ljust(80)


def write_sidecar(path, cards):
    """Write ``cards`` as a FITS header text (80-character cards, END,
    padded to 2880)."""
    text = "".join(_card(k, v) for k, v in cards.items()) + "END".ljust(80)
    text += " " * (-len(text) % 2880)
    with open(path, "w") as f:
        f.write(text)


def _pix2world(cards, x, y):
    """0-based pixel coordinates -> (ra, dec) in radians (TAN + SIP,
    zenithal: CRVAL is the native pole, LONPOLE the celestial pole's
    native longitude)."""
    u = x - cards["CRPIX1"]
    v = y - cards["CRPIX2"]
    du = torch.zeros_like(u)
    dv = torch.zeros_like(v)
    for key, val in cards.items():
        parts = key.split("_")
        if len(parts) == 3 and parts[0] in ("A", "B") and parts[1].isdigit():
            p, q = int(parts[1]), int(parts[2])
            term = val * (u**p) * (v**q)
            if parts[0] == "A":
                du = du + term
            else:
                dv = dv + term
    up, vp = u + du, v + dv
    xi = cards["CD1_1"] * up + cards["CD1_2"] * vp
    eta = cards["CD2_1"] * up + cards["CD2_2"] * vp
    phi = torch.atan2(xi, -eta)
    theta = torch.atan2(torch.full_like(xi, 180.0 / np.pi), torch.hypot(xi, eta))
    deg = np.pi / 180.0
    ap, dp, phip = cards["CRVAL1"] * deg, cards["CRVAL2"] * deg, cards["LONPOLE"] * deg
    sdp, cdp = np.sin(dp), np.cos(dp)
    st, ct = torch.sin(theta), torch.cos(theta)
    dphi = phi - phip
    sdec = st * sdp + ct * cdp * torch.cos(dphi)
    yy = -ct * torch.sin(dphi)
    xx = st * cdp - ct * sdp * torch.cos(dphi)
    dec = torch.atan2(sdec, torch.hypot(xx, yy))
    ra = torch.remainder(ap + torch.atan2(yy, xx), 2 * np.pi)
    return ra, dec


def area_factor(cards, nside, device):
    """(nside, nside) float32 pixel solid angle / Omega_ideal of the WCS
    ``cards`` (the port's ``area_factor_from_config``)."""
    N = nside
    sp = torch.linspace(-1, N, N + 2, dtype=torch.float64, device=device)
    yy, xx = torch.meshgrid(sp, sp, indexing="ij")
    ra, dec = _pix2world(cards, xx.reshape(-1), yy.reshape(-1))
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
    return (area / OMEGA_IDEAL).to(torch.float32).cpu().numpy()
