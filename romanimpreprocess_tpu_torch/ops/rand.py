"""Random draws of the simulator: one seeded ``torch.Generator``.

The reference keys its draws with a split tree of JAX random keys,
which torch cannot reproduce; here one generator on the device is
consumed in a fixed order (documented where the draws are made,
:mod:`..pipeline.sim_to_l1`), so two runs with one seed on one device
give the same numbers, and parity with the reference is statistical.
``torch.poisson`` is the Poisson sampler and ``torch._standard_gamma``
(which, unlike ``torch.distributions.Gamma.sample``, takes a generator)
the gamma sampler behind :func:`gamma`, :func:`beta` and
:func:`student_t`: the reference's fixed-round samplers work around a
TPU restriction and have no counterpart here.
"""

import torch


def sim_generator(seed, device):
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def poisson(gen, lam, shape=None):
    """Poisson deviates as float32 counts on ``gen``'s device; ``lam``
    (a tensor or a number) broadcasts to ``shape``."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=gen.device)
    if shape is not None:
        lam = lam.expand(tuple(shape))
    return torch.poisson(lam, generator=gen)


def gamma(gen, alpha):
    """Gamma(alpha, 1) deviates, float32, one per element of ``alpha``
    (a tensor on ``gen``'s device)."""
    return torch._standard_gamma(alpha.to(torch.float32), generator=gen)


def beta(gen, a, b):
    """Beta(a, b) deviates from two gammas (``a`` first)."""
    ga = gamma(gen, a)
    gb = gamma(gen, b)
    return ga / torch.clamp(ga + gb, min=1e-37)


def student_t(gen, df):
    """Student-t deviates with ``df`` degrees of freedom:
    Z / sqrt(ChiSq(df) / df), the normal drawn first."""
    df = df.to(torch.float32)
    z = torch.randn(df.shape, generator=gen, device=df.device)
    chi2 = 2.0 * gamma(gen, 0.5 * df)
    return z / torch.sqrt(torch.clamp(chi2 / df, min=1e-37))
