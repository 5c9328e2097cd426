"""Legendre-basis evaluation with linear extrapolation beyond |z|=1.

Equivalent of the reference's ``_lin`` helper
(``src/romanimpreprocess/utils/ipc_linearity.py:192-231``): evaluates

    phi = sum_L coefs[L] * P_L(z)

with the Legendre three-term recursion, where for ``|z| > 1`` each
``P_L(z)`` is replaced by its tangent-line continuation from the
boundary, ``sign(z)^L * (1 + L(L+1)/2 * (|z|-1))``.

Every step is one elementwise torch op in a fixed order; the CUDA
linearity kernel (``csrc/linearity.cu``) repeats the same rounded steps
so that the two agree bit for bit.
"""

import torch


def legendre_eval(z, coefs, linextrap=True):
    """Evaluate a per-pixel Legendre expansion.

    Parameters
    ----------
    z : tensor, any shape ``S``.
    coefs : tensor, shape ``(order+1,) + S`` (or broadcastable to it
        along the trailing axes).
    linextrap : bool — linearly extrapolate each P_L beyond |z|=1.

    Returns ``(phi, exflag)``; ``exflag`` is True where |z| > 1.
    """
    exflag = torch.abs(z) > 1.0
    phi = torch.broadcast_to(coefs[0], z.shape).to(z.dtype)
    poly_prev = torch.ones_like(z)
    poly = z
    if linextrap:
        signz = torch.sign(z)
        absz_excess = torch.abs(z) - 1.0
        sign_pow = signz  # sign(z)**L, updated in the loop

    for L in range(1, coefs.shape[0]):
        if linextrap:
            extrap = sign_pow * (1.0 + (L * (L + 1) / 2.0) * absz_excess)
            term = torch.where(exflag, extrap, poly)
            sign_pow = sign_pow * signz
        else:
            term = poly
        phi = phi + coefs[L] * term
        # Legendre recursion: (L+1) P_{L+1} = (2L+1) z P_L - L P_{L-1}
        poly_next = ((2 * L + 1) / (L + 1)) * z * poly - (L / (L + 1)) * poly_prev
        poly_prev = poly
        poly = poly_next
    return phi, exflag


def legendre_basis_1d(order, u):
    """Stack [P_0(u), ..., P_order(u)] for a 1-D coordinate tensor."""
    out = [torch.ones_like(u)]
    if order >= 1:
        out.append(u)
    for L in range(1, order):
        out.append(((2 * L + 1) / (L + 1)) * u * out[-1] - (L / (L + 1)) * out[-2])
    return torch.stack(out[: order + 1], dim=0)
