"""Random draws of the simulator: one seeded ``torch.Generator``.

The reference keys its draws with a split tree of JAX random keys,
which torch cannot reproduce; here one generator on the device is
consumed in a fixed order (documented where the draws are made,
:mod:`..pipeline.sim_to_l1`), so two runs with one seed on one device
give the same numbers, and parity with the reference is statistical.
``torch.poisson`` is the Poisson sampler: the reference's fixed-round
samplers work around a TPU restriction and have no counterpart here.
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
