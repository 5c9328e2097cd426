"""Configuration handling: YAML configs, READS decoding, backends, device.

The reference drives everything from plain YAML dicts with UPPERCASE
keys and two embedded mini-languages: the READS flattened-pair
read-pattern encoding and the noise-layer command strings like
``'Rz4PbrS2C1'``.  The ``*_BACKEND`` keys keep the JAX package's names
and values; here they choose between a hand-written CUDA kernel and its
plain PyTorch version, all five read once for an entry point
(:func:`resolve_kernels`).
"""

import re
from typing import NamedTuple

import torch
import yaml

#: backend names that select a hand-written CUDA kernel.  For the IPC
#: inverse of L1 -> L2 the three Pallas names of the JAX package keep
#: their meaning, each with its own entry point (``Kernels.ipc``):
#: 'pallas' the blocked slab entry, 'pallas-stream' the streaming slab
#: entry, 'pallas-frame' the frame inverse (one row-streaming kernel
#: serves all three, the frame inverse in the reference's Neumann
#: order).  Elsewhere (linearity, sky, the sim's forward IPC and pink
#: noise) there is one kernel per key and every name selects it.
KERNEL_NAMES = ("cuda", "pallas", "pallas-stream", "pallas-frame")

#: ``IPC_BACKEND`` value -> the calibration core's IPC route
_IPC_ROUTES = {"cuda": "cuda", "pallas-frame": "cuda", "pallas": "slab",
               "pallas-stream": "slab-stream"}


def resolve_device(device=None):
    """The torch device an entry point runs on.

    ``None`` means ``cuda``.  There is no silent CPU fallback: without
    a GPU the caller has to ask for ``device="cpu"`` explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


class Kernels(NamedTuple):
    """The kernel choice of one entry point (:func:`resolve_kernels`):
    'cuda' a hand-written kernel, 'xla' its plain PyTorch version.
    ``ipc`` is the L1 -> L2 core's IPC route, ``ipc_fwd`` the sim's
    forward IPC, ``lin`` the linearity and its inverse, ``med`` the
    medfits' block median, ``pink`` the fills' 1/f transform,
    ``contract`` the read contractions ('dot' or 'cuda')."""

    ipc: str
    ipc_fwd: str
    lin: str
    med: str
    pink: str
    contract: str


def _kernel_or_plain(config, key, dev):
    """A ``*_BACKEND`` key with one kernel as ``'cuda'`` or ``'xla'``:
    'auto' (the default) is the CUDA kernel on a ``cuda`` device and the
    plain PyTorch version elsewhere; 'xla' (the JAX package's name) the
    plain version; 'cuda' and the Pallas names the CUDA kernel, which a
    CPU device cannot run."""
    v = str(config.get(key, "auto")).lower()
    if v == "auto":
        return "cuda" if dev.type == "cuda" else "xla"
    if v == "xla":
        return "xla"
    if v in KERNEL_NAMES:
        if dev.type != "cuda":
            raise ValueError(
                f"{key}: {v!r} selects a CUDA kernel, but the device is "
                f"{dev}; use 'auto' or 'xla' on the CPU"
            )
        return "cuda"
    raise ValueError(f"{key}: unknown backend {v!r}")


def _contract(config, dev):
    """``CONTRACT_BACKEND`` as ``'dot'`` or ``'cuda'``, in the JAX package's
    meaning: 'dot' (the default) and 'auto' are ``torch.einsum``, as the
    reference computes it outside any kernel; 'pallas' or 'cuda' the
    contraction kernel, which a CPU device cannot run."""
    v = str(config.get("CONTRACT_BACKEND", "dot")).lower()
    if v in ("dot", "auto"):
        return "dot"
    if v in ("pallas", "cuda"):
        if dev.type != "cuda":
            raise ValueError(
                f"CONTRACT_BACKEND: {v!r} selects a CUDA kernel, but the "
                f"device is {dev}; use 'dot' on the CPU"
            )
        return "cuda"
    raise ValueError(f"CONTRACT_BACKEND: unknown backend {v!r}")


def resolve_kernels(config, device):
    """The five ``*_BACKEND`` keys of ``config`` as a :class:`Kernels`,
    read once for an entry point on ``device``.

    The core's IPC route ``ipc`` is as the JAX package routes it: 'cuda'
    the frame inverse ('cuda', 'pallas-frame', 'auto' on a ``cuda``
    device), 'slab' / 'slab-stream' the slab kernel's blocked / streaming
    form ('pallas' / 'pallas-stream'; the sum in another order, so the
    routes differ in the last bits), 'xla' the plain frame inverse.  On a
    CPU device a name that selects a kernel raises, as does an unknown one.
    """
    dev = torch.device(device)
    ipc_fwd = _kernel_or_plain(config, "IPC_BACKEND", dev)
    return Kernels(
        ipc=_IPC_ROUTES.get(str(config.get("IPC_BACKEND", "auto")).lower(), ipc_fwd),
        ipc_fwd=ipc_fwd,
        lin=_kernel_or_plain(config, "LIN_BACKEND", dev),
        med=_kernel_or_plain(config, "SKY_BACKEND", dev),
        pink=_kernel_or_plain(config, "PINK_BACKEND", dev),
        contract=_contract(config, dev),
    )


def load_config(path):
    with open(path) as f:
        return yaml.safe_load(f)


def reads_to_pattern(reads):
    """Flattened READS pair list -> MA read pattern (list of lists).

    ``[0,1, 1,2, 2,4]`` -> ``[[0], [1], [2, 3]]``; dropped frames are
    allowed (a pair's end below the next pair's start).
    """
    if len(reads) % 2 != 0:
        raise ValueError("READS must have an even number of entries")
    pattern = []
    for j in range(len(reads) // 2):
        lo, hi = int(reads[2 * j]), int(reads[2 * j + 1])
        if hi <= lo:
            raise ValueError(f"READS pair ({lo},{hi}) is empty")
        pattern.append(list(range(lo, hi)))
    return pattern


def pattern_to_reads(read_pattern):
    """Inverse of :func:`reads_to_pattern` (for provenance output)."""
    out = []
    for g in read_pattern:
        out.extend([int(g[0]), int(g[-1]) + 1])
    return out


def layer_subscript(cmd, ch):
    """Subscript of a capital-letter directive in a noise-layer command.

    ``layer_subscript('RS2Pg4', 'S') -> '2'``;
    ``layer_subscript('RS2Pg4', 'P') -> 'g4'``.
    Reference: ``gen_noise_image._get_subscript:33-57``.
    """
    return re.split(r"(?=[A-Z])", cmd.split(ch)[-1])[0]
