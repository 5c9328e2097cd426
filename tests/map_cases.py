"""Inputs for ``l1_to_l2.product_maps`` and the host numpy packaging it is
held to bit for bit: on the CPU (``tests/test_torch_l1_to_l2.py``) and on
the card (``tests/test_torch_cuda.py``).  Imports neither JAX nor torch."""

import numpy as np

INF, NAN = np.float32(np.inf), np.float32(np.nan)


def _qnan(bits):
    return np.array([bits], np.uint32).view(np.float32)[0]


#: (read, poisson) slope-error pairs at the edges of ``hypot``: an
#: infinity beside NaN (numpy gives inf), signed zeros, quiet NaN payloads
#: of both signs, squares past float32's range, subnormals
EDGE_PAIRS = [
    (INF, NAN), (NAN, INF), (-INF, NAN), (INF, 1.0), (0.0, -0.0), (NAN, NAN),
    (-0.0, -0.0), (1.0, -INF), (-INF, -INF), (_qnan(0x7FC12345), 1.0),
    (2.0, _qnan(0xFFC00001)), (_qnan(0xFFC0BEEF), _qnan(0x7FD00000)),
    (3e38, 3e38), (-3e38, 1.0), (1e-45, 1e-45), (1e-45, -3e-39), (1e-30, 1e30),
]

#: float16 edges for ``dumo`` / ``chisq``: the largest finite, the halfway
#: point to overflow and past it, ties to even, the smallest normal and
#: subnormals, underflow to zero, infinities, quiet NaNs, signed zero
HALF_EDGES = [
    65504.0, 65519.0, 65520.0, -65520.0, 1e6, -1e30, 1 + 2**-11, 1 + 3 * 2**-11,
    2049.0, 2051.0, 6.1035156e-05, 6.0e-05, 5.9604645e-08, 2.9802322e-08,
    2.98023259e-08, 8.940697e-08, 1e-8, -1e-10, -0.0, INF, -INF, NAN,
    _qnan(0x7FC12345), _qnan(0xFFC00001),
]


def inputs(n=128, nb=4, seed=0):
    """The core outputs ``product_maps`` reads, float32 (n, n) maps: random
    values of both signs over 40 decades (the slope errors) and over 16
    (``dumo``, ``chisq``, around float16's range), the edges along the
    first active rows, and NaN in the border (cropped off)."""
    rng = np.random.default_rng(seed)

    def decades(lo, hi):
        return (rng.standard_normal((n, n)) * 10.0 ** rng.uniform(lo, hi, (n, n))
                ).astype(np.float32)

    out = {"slope_err_read": decades(-20, 20), "slope_err_poisson": decades(-20, 20),
           "dumo": decades(-10, 6), "chisq": decades(-10, 6)}
    cols = slice(nb, nb + len(EDGE_PAIRS))
    out["slope_err_read"][nb, cols] = [a for a, _ in EDGE_PAIRS]
    out["slope_err_poisson"][nb, cols] = [b for _, b in EDGE_PAIRS]
    for i, k in enumerate(("dumo", "chisq")):
        out[k][nb + 1 + i, nb:nb + len(HALF_EDGES)] = HALF_EDGES
    for a in out.values():
        a[:nb] = NAN
    return out


def numpy_maps(out, nb):
    """The derived L2 maps as host numpy packaging made them from the
    core's host outputs: ``hypot`` over the frame, the float32 squares and
    the float16 casts of the active region."""
    ser, sep = out["slope_err_read"], out["slope_err_poisson"]
    act = slice(nb, ser.shape[-1] - nb)
    with np.errstate(all="ignore"):
        maps = {"err": np.hypot(ser, sep).astype(np.float32)[act, act],
                "var_poisson": np.asarray(sep[act, act] ** 2, np.float32),
                "var_rnoise": np.asarray(ser[act, act] ** 2, np.float32)}
        for k in ("dumo", "chisq"):
            if k in out:
                maps[k] = np.asarray(out[k][act, act], np.float16)
    return maps


def bits(a):
    """The array's bit patterns (unsigned integers of its width)."""
    a = np.ascontiguousarray(a)
    return a.view(np.dtype(f"u{a.itemsize}"))
