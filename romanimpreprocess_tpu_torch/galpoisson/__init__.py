"""Pseudo-Poisson debiasing draws (the "GalPoisson" subsystem).

Monte-Carlo noise layers for photometric-bias studies: per-pixel random
deviates whose 2nd-4th central moments match those of the ramp-fit
noise, drawn from the appropriate Pearson-family distribution.

Re-implements ``L1_to_L2/GalPoisson`` of the reference:

- :func:`get_tilde_nus` — the O(N^2) cumulative-sum computation of the
  nu-tilde moment combinations (``find_tilnus.py:14-76``),
- :func:`draw_from_pearson` — the beta1/beta2 admissibility dispatch to
  Pearson types 1/3/4/5/6 (``draw_with_tilnus.py:12-126``) on the host
  (numpy), with the reference's scalar type-4 rejection loops
  vectorized,
- :func:`draw_from_pearson_torch` — the same dispatch on a torch device,
  drawn from an explicit ``torch.Generator`` (:mod:`.pearson_torch`).

``find_tilnus``, ``denoise_construct`` and ``pearson`` are numpy/scipy
modules, kept here as copies so the port imports nothing of the JAX
package.
"""

from .find_tilnus import get_tilde_nus, raw_weights  # noqa: F401
from .pearson import draw_from_pearson  # noqa: F401
from .pearson_torch import draw_from_pearson_torch  # noqa: F401
