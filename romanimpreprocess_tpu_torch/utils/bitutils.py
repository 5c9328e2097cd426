"""Bit-plane helpers (reference ``utils/bitutils.py:14-36``)."""

import numpy as np


def convert_uint32_to_bits(arr):
    """(ny, nx) uint32 -> (32, ny, nx) uint8 of 0/1 bit planes.

    Vectorized over the bit axis (the reference loops in Python).
    """
    arr = np.asarray(arr, dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)[:, None, None]
    return ((arr[None, :, :] >> shifts) & np.uint32(1)).astype(np.uint8)
