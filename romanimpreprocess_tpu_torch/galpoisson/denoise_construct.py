"""Reference (O(N^4)) MultiAccum central-moment construction.

Cross-check implementation of the nu-tilde computation: builds the full
2nd/3rd/4th joint central-moment tensors of the cumulative Poisson
process at the raw-frame level (min-index structure), compresses them
through the raw->MA matrix L, contracts with the zero-sum ramp weights,
and forms the debias combinations.  Equivalent to the production
O(N^2) algorithm in :mod:`.find_tilnus`; kept (as the reference keeps
``denoise_construct.py``) as the independently-derived oracle.

Moment structure of the cumulative counts C_a of a unit-rate Poisson
process (per unit Ibar):

    cov(C_a, C_b)            = min(a, b)
    mu3(C_a, C_b, C_c)       = min(a, b, c)
    mu4 linear-in-Ibar term  = min(a, b, c, d)
    mu4 quadratic term       = sum over the 3 pairings of
                               min(pair1) * min(pair2)
"""

import numpy as np

from .find_tilnus import raw_weights


def raw_central_moment_tensors(N_beta, a_beta):
    """(mom2, mom3, mom4lin, mom4quad) min-index tensors, Ibar factored out."""
    n = int(np.max(np.asarray(N_beta) + np.asarray(a_beta)))
    idx = np.arange(n)
    i2, j2 = np.meshgrid(idx, idx, indexing="ij")
    mom2 = np.minimum(i2, j2)
    i3, j3, k3 = np.meshgrid(idx, idx, idx, indexing="ij")
    mom3 = np.minimum.reduce([i3, j3, k3])
    i4, j4, k4, l4 = np.meshgrid(idx, idx, idx, idx, indexing="ij")
    mom4lin = np.minimum.reduce([i4, j4, k4, l4])
    mom4quad = (
        np.minimum(i4, j4) * np.minimum(k4, l4)
        + np.minimum(i4, k4) * np.minimum(j4, l4)
        + np.minimum(i4, l4) * np.minimum(j4, k4)
    )
    return mom2, mom3, mom4lin, mom4quad


def get_nus(N_beta, a_beta):
    """MA-frame moment tensors nu_21 (M,M), nu_31 (M,M,M), nu_41 and
    nu_42 (M,M,M,M) by compressing the raw tensors through L."""
    L = raw_weights(N_beta, a_beta)
    mom2, mom3, mom4lin, mom4quad = raw_central_moment_tensors(N_beta, a_beta)
    nu21 = np.einsum("ia,jb,ab->ij", L, L, mom2, optimize=True)
    nu31 = np.einsum("ia,jb,kc,abc->ijk", L, L, L, mom3, optimize=True)
    nu41 = np.einsum("ia,jb,kc,ld,abcd->ijkl", L, L, L, L, mom4lin, optimize=True)
    nu42 = np.einsum("ia,jb,kc,ld,abcd->ijkl", L, L, L, L, mom4quad, optimize=True)
    return nu21, nu31, nu41, nu42


def contract(nu, W):
    """Contract a rank-2/3/4 nu tensor with zero-sum weights W."""
    W = np.asarray(W, dtype=float)
    assert np.isclose(W.sum(), 0.0, atol=1e-10)
    subs = {2: "a,b,ab->", 3: "a,b,c,abc->", 4: "a,b,c,d,abcd->"}[nu.ndim]
    return np.einsum(subs, *([W] * nu.ndim), nu, optimize=True)


def get_tilde_nus(N_beta, a_beta, W):
    """nu-tilde's via the full tensor construction (eq. 32 combinations)."""
    nu21, nu31, nu41, nu42 = get_nus(N_beta, a_beta)
    n21 = contract(nu21, W)
    n31 = contract(nu31, W)
    n41 = contract(nu41, W)
    n42 = contract(nu42, W)
    return (
        n21,
        n31 - 3 * n21**2,
        n41 - 10 * n21 * n31 - n21 * n42 + 18 * n21**3,
        n42,
    )


def get_tilde_nus_from_list(grps, wt):
    """Same, from a read-pattern group list (consecutive reads per group)."""
    a_beta = np.array([g[0] for g in grps], dtype=np.int64)
    N_beta = np.array([len(g) for g in grps], dtype=np.int64)
    return get_tilde_nus(N_beta, a_beta, wt)
