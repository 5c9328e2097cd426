"""Metadata-driven sky background for the L1 simulator.

The reference obtains its blank sky+dark image from romanisim's
``simulate_counts``, which evaluates the zodiacal-light background from
the pointing, filter bandpass, and observation date
(``src/romanimpreprocess/from_sim/sim_to_isim.py:596,637`` calling
``romanisim.image.simulate_counts``).  romanisim is not a dependency
of this package, so this module provides a small self-consistent analytic model
with the same inputs and the same qualitative behavior:

- a per-filter count rate at the **ecliptic pole** (the "minzodi"
  benchmark level used in Roman WFI planning documents, ~0.2-0.3
  e/s/pix in the wide filters, ~0.8 in the ultra-wide F146),
- an ecliptic-latitude brightening factor fit to the shape of the
  Leinert et al. (1998, A&AS 127, 1) zodiacal-light tables at solar
  elongation 90 deg: ``1 + 1.9 (1 - sin|beta|)^1.8`` (about 2.9x
  brighter on the ecliptic than at the poles, the ~2-3x variation the
  real sky shows),
- a solar-elongation factor (date-dependent through the mean solar
  longitude) ``clip(1 + 0.8 cos eps, 0.6, 1.8)`` — brighter toward the
  Sun, mildly darker at anti-solar elongations; Roman's observatory
  keeps ``eps`` in roughly [54, 126] deg so the factor stays bounded,
- a per-filter detector/telescope **thermal floor** (dominant in F213).

Everything is host-side scalar metadata math; the returned rate is a
single e/s/pix scalar which the simulator multiplies by the flat field
(the reference applies the same flat to its romanisim sky image).
``SKY_RATE`` in the sim config still overrides the model entirely.
"""

import math
import re

# e/s/pix zodiacal benchmark at the ecliptic pole, per filter
# (approximate Roman WFI "minzodi" planning levels)
ZODI_POLE = {
    "F062": 0.25,
    "F087": 0.25,
    "F106": 0.28,
    "F129": 0.29,
    "F146": 0.78,
    "F158": 0.28,
    "F184": 0.19,
    "F213": 0.18,
    "W146": 0.78,
}

# e/s/pix internal thermal background, per filter (long-wave dominated)
THERMAL = {
    "F062": 0.003,
    "F087": 0.003,
    "F106": 0.003,
    "F129": 0.003,
    "F146": 0.08,
    "F158": 0.04,
    "F184": 0.17,
    "F213": 4.52,
    "W146": 0.08,
}

_OBLIQUITY = math.radians(23.4393)


def ecliptic_coords(ra_deg, dec_deg):
    """Equatorial (deg) -> ecliptic (lambda, beta) in radians."""
    ra = math.radians(ra_deg)
    dec = math.radians(dec_deg)
    ce, se = math.cos(_OBLIQUITY), math.sin(_OBLIQUITY)
    sb = math.sin(dec) * ce - math.cos(dec) * se * math.sin(ra)
    beta = math.asin(max(-1.0, min(1.0, sb)))
    lam = math.atan2(
        math.sin(ra) * ce + math.tan(dec) * se, math.cos(ra)
    )
    return lam % (2 * math.pi), beta


def sun_ecliptic_longitude(date):
    """Mean solar ecliptic longitude (radians) from an ISO date string.

    Mean-motion approximation (J2000 epoch, 0.9856 deg/day) — within
    ~2 deg of the true Sun, far below the model's own accuracy.
    """
    m = re.match(r"(\d{4})-(\d{2})-(\d{2})", str(date) if date else "")
    if not m:
        return 0.0
    y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
    # days since J2000.0 (Fliegel-Van Flandern day number)
    a = (14 - mo) // 12
    yy = y + 4800 - a
    mm = mo + 12 * a - 3
    jdn = d + (153 * mm + 2) // 5 + 365 * yy + yy // 4 - yy // 100 + yy // 400 - 32045
    n = jdn - 2451545
    return math.radians((280.46 + 0.9856474 * n) % 360.0)


def zodi_factor(beta, elongation):
    """Dimensionless zodiacal brightening vs the ecliptic pole."""
    lat = 1.0 + 1.9 * (1.0 - abs(math.sin(beta))) ** 1.8
    elo = max(0.6, min(1.8, 1.0 + 0.8 * math.cos(elongation)))
    return lat * elo


def sky_background_rate(filter_name, ra_deg, dec_deg, date=None):
    """Sky+thermal background count rate, e/s/pix.

    Same metadata inputs as romanisim's ``simulate_counts`` background
    path (filter bandpass, pointing, date); unknown filters fall back
    to the F158 levels.
    """
    f = str(filter_name)[:4].upper()
    pole = ZODI_POLE.get(f, ZODI_POLE["F158"])
    thermal = THERMAL.get(f, THERMAL["F158"])
    lam, beta = ecliptic_coords(float(ra_deg), float(dec_deg))
    lam_sun = sun_ecliptic_longitude(date)
    # solar elongation of the line of sight
    cos_eps = math.cos(beta) * math.cos(lam - lam_sun)
    eps = math.acos(max(-1.0, min(1.0, cos_eps)))
    return pole * zodi_factor(beta, eps) + thermal
