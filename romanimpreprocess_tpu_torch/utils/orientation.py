"""Focal-plane orientation: SCA sky positions from pointing metadata.

Re-implements the reference's ``utils/orientation.py:9-119``: given the
L1/L2 ``wcsinfo`` pointing (ra_ref, dec_ref, roll_ref) and optional
velocity-aberration scale factor, computes the WFI field center, the
position angle, and the 18 SCA center coordinates by chaining the
FPA -> INT -> BST -> J2000 rotations.  Intended for plotting / layout
decisions, not precision astrometry.
"""

import os

import numpy as np

from ..io import asdf_lite

DEG = np.pi / 180.0

#: WFI SCA reference positions in field-angle coordinates (degrees),
#: WFI01..WFI18 (instrument geometry; same table as the reference).
sca_ref_pos = np.array(
    [
        [-0.06784, -0.03653], [-0.0678, 0.10972], [-0.06769, 0.24053],
        [-0.2034, -0.0636], [-0.2035, 0.08296], [-0.20338, 0.21345],
        [-0.33864, -0.12921], [-0.33894, 0.01811], [-0.34003, 0.14753],
        [0.06784, -0.03653], [0.0678, 0.10972], [0.06769, 0.24053],
        [0.2034, -0.0636], [0.2035, 0.08296], [0.20338, 0.21345],
        [0.33864, -0.12921], [0.33894, 0.01811], [0.34003, 0.14753],
    ]
)

#: Field-angle offset of the FPA center from the telescope boresight.
FPA_BORESIGHT_OFFSET = 0.496 * DEG
#: BST roll zero-point relative to roll_ref.
BST_ROLL_ZERO = -150.0 * DEG


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def fpa_to_j2000_matrix(ra_ref, dec_ref, roll_ref):
    """Rotation matrix from FPA field-angle coordinates to J2000.

    Chain: J2000 <- (RA rotation) <- (Dec rotation) <- BST roll <- FPA
    tilt, with the FPA +X axis aligned to INT +X and the telescope
    boresight along INT +Z.
    """
    roll = BST_ROLL_ZERO + roll_ref
    off = FPA_BORESIGHT_OFFSET
    m_dec = np.array(
        [
            [np.sin(dec_ref), 0.0, np.cos(dec_ref)],
            [0.0, 1.0, 0.0],
            [-np.cos(dec_ref), 0.0, np.sin(dec_ref)],
        ]
    )
    m_roll = np.array(
        [
            [np.cos(roll), np.sin(roll), 0.0],
            [-np.sin(roll), np.cos(roll), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    m_fpa = np.array(
        [
            [1.0, 0.0, 0.0],
            [0.0, -np.cos(off), np.sin(off)],
            [0.0, -np.sin(off), -np.cos(off)],
        ]
    )
    return _rot_z(ra_ref) @ m_dec @ m_roll @ m_fpa


def get_orientation(afile):
    """WFI center RA/Dec/PA and the 18 SCA centers, all in degrees.

    ``afile`` is an open tree (dict-like with ``roman.meta``) or a path.
    """
    if isinstance(afile, (str, os.PathLike)):
        meta = asdf_lite.open(os.fspath(afile))["roman"]["meta"]
    else:
        meta = afile["roman"]["meta"]
    ra_ref = meta["wcsinfo"]["ra_ref"] * DEG
    dec_ref = meta["wcsinfo"]["dec_ref"] * DEG
    roll_ref = meta["wcsinfo"]["roll_ref"] * DEG
    scale_factor = meta.get("velocity_aberration", {}).get("scale_factor", 1.0)

    rmat = fpa_to_j2000_matrix(ra_ref, dec_ref, roll_ref)

    # field center: image of the boresight direction
    ra = np.arctan2(rmat[1, 2], rmat[0, 2]) / DEG + 180.0
    dec = np.arctan2(-rmat[2, 2], np.hypot(rmat[0, 2], rmat[1, 2])) / DEG

    # SCA unit vectors in FPA coordinates (sinc correction for the
    # gnomonic field angles), aberration-scaled
    xy = sca_ref_pos.T * DEG / scale_factor
    xy = xy * np.sinc(np.hypot(xy[0], xy[1]) / np.pi)[None, :]
    z = -np.sqrt(1.0 - xy[0] ** 2 - xy[1] ** 2)
    vecs = np.vstack([xy, z[None, :]])
    v_j2000 = rmat @ vecs
    ra_sca = np.arctan2(-v_j2000[1], -v_j2000[0]) / DEG + 180.0
    dec_sca = np.arctan2(v_j2000[2], np.hypot(v_j2000[0], v_j2000[1])) / DEG

    # position angle: direction of celestial North seen in WFI coords
    north = np.array(
        [
            -np.sin(dec_ref) * np.cos(ra_ref),
            -np.sin(dec_ref) * np.sin(ra_ref),
            np.cos(dec_ref),
        ]
    )
    v_wfi = rmat.T @ north
    pa = np.arctan2(-v_wfi[0], -v_wfi[1]) / DEG + 180.0

    return {"ra": ra, "dec": dec, "pa": pa, "ra_sca": ra_sca, "dec_sca": dec_sca}
