"""nu-tilde moment combinations of weighted MultiAccum ramps.

The ramp-fit estimate is a weighted sum of resultant means of a Poisson
process; its 2nd-4th cumulant combinations (nu-tilde's) follow from the
raw->MA compression matrix.  This is the production O(N^2) algorithm of
the reference (``GalPoisson/find_tilnus.py:44-76``): with L the
raw-to-MA averaging matrix and T its reversed cumulative sum, the
weighted per-raw-frame influence is W.T[:, 1:], and

    nu_p1 = sum (W T)^p,   nu_42 = 3 nu_21^2,
    tilnu_21 = nu_21,
    tilnu_31 = nu_31 - 3 nu_21^2,
    tilnu_41 = nu_41 - 10 nu_21 nu_31 - nu_21 nu_42 + 18 nu_21^3,
    tilnu_42 = nu_42.

(The equivalent O(N^4) central-moment construction, the reference's
``denoise_construct.py``, is in :mod:`.denoise_construct` as the
cross-check implementation.)
"""

import numpy as np


def raw_weights(N_beta, a_beta):
    """Raw-frame -> MA-frame averaging matrix L, shape (M, nreads).

    ``N_beta[k]`` frames starting at index ``a_beta[k]`` average into MA
    frame k with weight 1/N_beta[k].
    """
    N_beta = np.asarray(N_beta)
    a_beta = np.asarray(a_beta)
    assert len(N_beta) == len(a_beta)
    nreads = int(np.max(a_beta + N_beta))
    L = np.zeros((len(N_beta), nreads))
    for k in range(len(N_beta)):
        L[k, a_beta[k] : a_beta[k] + N_beta[k]] = 1.0 / N_beta[k]
    return L


def get_tilde_nus(N_beta, a_beta, W):
    """nu-tilde's (tilnu_21, tilnu_31, tilnu_41, tilnu_42) for weights W."""
    L = raw_weights(N_beta, a_beta)
    T = np.cumsum(L[:, ::-1], axis=1)[:, ::-1]
    WT = np.dot(np.asarray(W, dtype=float), T[:, 1:])
    nu_21 = np.sum(WT**2)
    nu_31 = np.sum(WT**3)
    nu_41 = np.sum(WT**4)
    nu_42 = 3 * nu_21**2
    tilnu_21 = nu_21
    tilnu_31 = nu_31 - 3 * nu_21**2
    tilnu_41 = nu_41 - 10 * nu_21 * nu_31 - nu_21 * nu_42 + 18 * nu_21**3
    tilnu_42 = nu_42
    return tilnu_21, tilnu_31, tilnu_41, tilnu_42
