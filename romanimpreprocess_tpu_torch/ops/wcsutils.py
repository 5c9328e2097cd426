"""FITS SIP WCS: evaluation, inversion, pixel solid angles, SCA flips.

Self-contained re-implementation of the WCS functionality the reference
gets from astropy/galsim/gwcs:

- SIP distortion + TAN/STG celestial projection with LONPOLE handling
  (used for the truth-image WCS, ``sim_to_isim.py:506``),
- per-pixel solid angles by equal-area reprojection Jacobians
  (reference ``utils/coordutils.py:17-82``),
- detector->science frame flips that negate the appropriate SIP
  coefficients (reference ``sim_to_isim.py:63-160``).

All math follows Calabretta & Greisen (2002) paper II conventions.
``SIPWCS.pix2world`` / ``pix2sky`` take numpy arrays (host metadata
work, O(ms)) or torch tensors, with one body for both (:data:`_NUMPY`,
:data:`_TORCH`); :func:`pixelarea` evaluates it in torch float64 on the
grid's device.
"""

from types import SimpleNamespace

import numpy as np
import torch

DEG = np.pi / 180.0

# the elementwise functions of the WCS arithmetic, by array type
_NUMPY = SimpleNamespace(zeros_like=np.zeros_like, hypot=np.hypot, atan2=np.arctan2,
                         atan=np.arctan, sin=np.sin, cos=np.cos, mod=np.mod)
_TORCH = SimpleNamespace(zeros_like=torch.zeros_like, hypot=torch.hypot, atan2=torch.atan2,
                         atan=torch.atan, sin=torch.sin, cos=torch.cos, mod=torch.remainder)


def _fns(x):
    return _TORCH if isinstance(x, torch.Tensor) else _NUMPY


class SIPWCS:
    """TAN/STG + SIP world coordinate system from a FITS header.

    Pixel coordinates here are **0-based** (the caller adjusts CRPIX when
    building from a 1-based FITS header; `from_header` handles it).
    """

    def __init__(self, crpix, cd, crval, ctype="TAN", lonpole=180.0,
                 a_coefs=None, b_coefs=None):
        self.crpix = np.asarray(crpix, dtype=float)  # 0-based reference pixel
        self.cd = np.asarray(cd, dtype=float)  # 2x2, deg/pixel
        self.crval = np.asarray(crval, dtype=float)  # deg
        self.ctype = ctype
        self.lonpole = float(lonpole)
        self.a = a_coefs  # dict {(p, q): coef} or None
        self.b = b_coefs

    # -- construction ------------------------------------------------------
    @classmethod
    def from_header(cls, h, zero_based=False):
        """Build from a FITS header (1-based CRPIX unless zero_based)."""
        off = 0.0 if zero_based else 1.0
        crpix = np.array([h["CRPIX1"] - off, h["CRPIX2"] - off])
        cd = np.array(
            [[h["CD1_1"], h.get("CD1_2", 0.0)], [h.get("CD2_1", 0.0), h["CD2_2"]]]
        )
        crval = np.array([h["CRVAL1"], h["CRVAL2"]])
        ctype = str(h.get("CTYPE1", "RA---TAN"))
        proj = "STG" if "STG" in ctype else "TAN"
        lonpole = float(h.get("LONPOLE", 180.0))

        def read_sip(prefix):
            if f"{prefix}_ORDER" not in h:
                return None
            order = int(h[f"{prefix}_ORDER"])
            coefs = {}
            for p in range(order + 1):
                for q in range(order + 1 - p):
                    key = f"{prefix}_{p}_{q}"
                    if key in h:
                        coefs[(p, q)] = float(h[key])
            return coefs

        return cls(crpix, cd, crval, proj, lonpole, read_sip("A"), read_sip("B"))

    # -- SIP polynomial ----------------------------------------------------
    @staticmethod
    def _sip_poly(coefs, u, v):
        out = _fns(u).zeros_like(u)
        if coefs:
            for (p, q), c in coefs.items():
                out = out + c * (u**p) * (v**q)
        return out

    # -- projections -------------------------------------------------------
    def _native_from_plane(self, xi, eta):
        """Intermediate world coords (deg) -> native spherical (phi, theta)."""
        f = _fns(xi)
        R = f.hypot(xi, eta)
        phi = f.atan2(xi, -eta)
        with np.errstate(divide="ignore"):
            if self.ctype == "TAN":
                theta = f.atan2(f.zeros_like(R) + 180.0 / np.pi, R)
            else:  # STG
                theta = np.pi / 2.0 - 2.0 * f.atan(np.pi * R / 360.0)
        return phi, theta

    def _plane_from_native(self, phi, theta):
        if self.ctype == "TAN":
            R = (180.0 / np.pi) / np.tan(theta)
        else:
            R = (360.0 / np.pi) * np.tan((np.pi / 2.0 - theta) / 2.0)
        return R * np.sin(phi), -R * np.cos(phi)

    def _celestial_from_native(self, phi, theta):
        """Rotate native (phi, theta) to (ra, dec), radians in/out.

        Zenithal projection: the fiducial point (CRVAL) is the native
        pole; LONPOLE is the native longitude of the celestial pole.
        """
        f = _fns(theta)
        ap = self.crval[0] * DEG
        dp = self.crval[1] * DEG
        phip = self.lonpole * DEG
        sdp, cdp = np.sin(dp), np.cos(dp)
        st, ct = f.sin(theta), f.cos(theta)
        dphi = phi - phip
        sdec = st * sdp + ct * cdp * f.cos(dphi)
        y = -ct * f.sin(dphi)
        x = st * cdp - ct * sdp * f.cos(dphi)
        # arctan2(sin dec, |cos dec|) instead of arcsin(sin dec): the
        # rotation is orthogonal, so hypot(x, y) == cos(dec) exactly —
        # arcsin loses sqrt(eps) (~1e-8 rad, ~4e-4 px) near the pole,
        # i.e. exactly at the reference pixel
        dec = f.atan2(sdec, f.hypot(x, y))
        ra = ap + f.atan2(y, x)
        return f.mod(ra, 2 * np.pi), dec

    def _native_from_celestial(self, ra, dec):
        ap = self.crval[0] * DEG
        dp = self.crval[1] * DEG
        phip = self.lonpole * DEG
        sdp, cdp = np.sin(dp), np.cos(dp)
        sd, cdv = np.sin(dec), np.cos(dec)
        dra = ra - ap
        st = sd * sdp + cdv * cdp * np.cos(dra)
        y = -cdv * np.sin(dra)
        x = sd * cdp - cdv * sdp * np.cos(dra)
        # stable pole form (see _celestial_from_native): the round trip
        # must hold to ~1e-6 px for the embedded-WCS reconstruction
        # contract, and arcsin alone cannot deliver that near CRPIX
        theta = np.arctan2(st, np.hypot(x, y))
        phi = phip + np.arctan2(y, x)
        return phi, theta

    # -- public API --------------------------------------------------------
    def pix2world(self, x, y):
        """0-based pixel coords -> (ra, dec) in degrees."""
        ra, dec = self.pix2sky(x, y)
        return ra / DEG, dec / DEG

    def pix2sky(self, x, y):
        """0-based pixel coords -> (ra, dec) in radians: numpy arrays, or
        torch tensors on their device in their dtype."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, dtype=float)
            y = np.asarray(y, dtype=float)
        u = x - self.crpix[0]
        v = y - self.crpix[1]
        up = u + self._sip_poly(self.a, u, v)
        vp = v + self._sip_poly(self.b, u, v)
        xi = self.cd[0, 0] * up + self.cd[0, 1] * vp
        eta = self.cd[1, 0] * up + self.cd[1, 1] * vp
        phi, theta = self._native_from_plane(xi, eta)
        return self._celestial_from_native(phi, theta)

    def world2pix(self, ra, dec, niter=12):
        """(ra, dec) degrees -> 0-based pixel coords (iterative SIP inverse)."""
        phi, theta = self._native_from_celestial(
            np.asarray(ra, dtype=float) * DEG, np.asarray(dec, dtype=float) * DEG
        )
        xi, eta = self._plane_from_native(phi, theta)
        cdi = np.linalg.inv(self.cd)
        up = cdi[0, 0] * xi + cdi[0, 1] * eta
        vp = cdi[1, 0] * xi + cdi[1, 1] * eta
        # fixed-point inversion of u + A(u,v) = up
        u, v = up.copy(), vp.copy()
        for _ in range(niter):
            u = up - self._sip_poly(self.a, u, v)
            v = vp - self._sip_poly(self.b, u, v)
        return u + self.crpix[0], v + self.crpix[1]

    # -- serialization -----------------------------------------------------
    def to_cards(self):
        """Flat dict of FITS-style cards (CRPIX kept **0-based**).

        Round-trips through ``from_header(cards, zero_based=True)``;
        used to embed the WCS into the L2 ASDF meta (the reference
        embeds a gwcs via romanisim ``make_asdf(imwcs=...)``,
        ``gen_cal_image.py:653-662``).
        """
        suffix = "STG" if self.ctype == "STG" else "TAN"
        cards = {
            "CTYPE1": f"RA---{suffix}" + ("-SIP" if self.a else ""),
            "CTYPE2": f"DEC--{suffix}" + ("-SIP" if self.b else ""),
            "CRPIX1": float(self.crpix[0]),
            "CRPIX2": float(self.crpix[1]),
            "CRVAL1": float(self.crval[0]),
            "CRVAL2": float(self.crval[1]),
            "CD1_1": float(self.cd[0, 0]),
            "CD1_2": float(self.cd[0, 1]),
            "CD2_1": float(self.cd[1, 0]),
            "CD2_2": float(self.cd[1, 1]),
            "LONPOLE": float(self.lonpole),
        }
        for prefix, coefs in (("A", self.a), ("B", self.b)):
            if not coefs:
                continue
            cards[f"{prefix}_ORDER"] = max(p + q for (p, q) in coefs)
            for (p, q), c in sorted(coefs.items()):
                cards[f"{prefix}_{p}_{q}"] = float(c)
        return cards


def pixelarea(wcs, N=4088, device=None):
    """(N, N) pixel solid angles in steradians, computed in torch float64
    on ``device``: a tensor there, or without ``device`` a numpy array
    (computed on the CPU).

    Same equal-area azimuthal reprojection + central-difference Jacobian
    as the reference (``coordutils.py:59-82``), with the projection pole
    chosen in the SAME hemisphere as the first pixel (so the field sits
    near the pole, where the equal-area mapping is well-conditioned —
    do not "fix" this to the opposite pole, which would put the field
    near the degenerate antipode).  The hemisphere is read on the host
    from that one pixel, so the device work launches without a sync.
    The Jacobian differences coordinates of order 1 over 2 pixels
    (about 1e-6 rad): float64 keeps about ten digits of it, float32 not one.
    """
    dev = torch.device("cpu" if device is None else device)
    north = float(wcs.pix2sky(-1.0, -1.0)[1]) > 0
    sp = torch.linspace(-1, N, N + 2, dtype=torch.float64, device=dev)
    yy, xx = torch.meshgrid(sp, sp, indexing="ij")
    ra, dec = wcs.pix2sky(xx.reshape(-1), yy.reshape(-1))

    theta = np.pi / 2.0 - dec if north else np.pi / 2.0 + dec
    rho = 2.0 * torch.sin(theta / 2.0)
    u = (rho * torch.cos(ra)).reshape((N + 2, N + 2))
    v = (rho * torch.sin(ra)).reshape((N + 2, N + 2))

    J11 = (u[1:-1, 2:] - u[1:-1, :-2]) / 2.0
    J12 = (u[2:, 1:-1] - u[:-2, 1:-1]) / 2.0
    J21 = (v[1:-1, 2:] - v[1:-1, :-2]) / 2.0
    J22 = (v[2:, 1:-1] - v[:-2, 1:-1]) / 2.0
    area = torch.abs(J11 * J22 - J21 * J12)
    return area.numpy() if device is None else area


# --------------------------------------------------------------------------
# Detector -> science frame SIP flips (reference sim_to_isim.py:63-160)
# --------------------------------------------------------------------------

def sip_hflip(data, header):
    """Horizontal flip of image + SIP WCS header, in place.

    Flipping the x-axis negates CRPIX1 (about the center), the first CD
    column, and the SIP coefficients with even p (A) / odd p (B), which
    reverses the direction of the SIP u-axis.
    """
    ny, nx = data.shape
    data[:, :] = data[:, ::-1]
    header["CRPIX1"] = nx + 1 - header["CRPIX1"]
    header["CD1_1"] = -header["CD1_1"]
    header["CD2_1"] = -header["CD2_1"]
    _flip_sip(header, axis="u")


def sip_vflip(data, header):
    """Vertical flip of image + SIP WCS header, in place."""
    ny, nx = data.shape
    data[:, :] = data[::-1, :]
    header["CRPIX2"] = ny + 1 - header["CRPIX2"]
    header["CD1_2"] = -header["CD1_2"]
    header["CD2_2"] = -header["CD2_2"]
    _flip_sip(header, axis="v")


def _flip_sip(header, axis):
    try:
        a_order = int(header["A_ORDER"])
        b_order = int(header["B_ORDER"])
    except (KeyError, ValueError, TypeError):
        return
    # u-axis flip: A terms with even p, B terms with odd p change sign.
    # v-axis flip: A terms with odd q, B terms with even q change sign.
    for prefix, order in (("A", a_order), ("B", b_order)):
        for p in range(order + 1):
            for q in range(order + 1 - p):
                key = f"{prefix}_{p}_{q}"
                if key not in header:
                    continue
                if axis == "u":
                    negate = (p % 2 == 0) if prefix == "A" else (p % 2 == 1)
                else:
                    negate = (q % 2 == 1) if prefix == "A" else (q % 2 == 0)
                if negate:
                    header[key] = -float(header[key])
