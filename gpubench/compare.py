"""The comparison that decides ``correct``.

The program's L2 tree against the plain reference's arrays
(:func:`.reference.l2.calibrate`), on the same L1 tree, cal pack and
area map.  Two numbers, each the worst over its fields:

- ``exact_frac``: the share of values that differ among the outputs
  that are compared exactly, and of the float outputs' values that are
  not finite on both sides alike: ``dq``, the four border DQ strips and
  ``endslice`` (with ``SLICEOUT``; DQ bit for bit, a rule of the port), the four border
  reference-pixel strips and ``amp33`` (passed through);
- ``maps_gap``: the widest gap ``|p - r| / (|r| + m)`` over the float
  outputs, ``m`` the median of ``|r|`` of the field: ``data``,
  ``data_withsky``, ``err``, ``var_poisson``, ``var_rnoise``, for the
  likelihood fit ``dumo`` and ``chisq`` (float16, read in float32), and
  ``skycoefs`` (against the largest coefficient) and ``medsky``, over
  the values finite on both sides.  Where a value is finite on one side
  only, or non-finite and unequal on both, it counts in ``exact_frac``.

The gaps are taken with PyTorch on ``device``.
"""

import numpy as np
import torch

EXACT_FIELDS = ("dq", "dq_border_ref_pix_left", "dq_border_ref_pix_right",
                "dq_border_ref_pix_top", "dq_border_ref_pix_bottom",
                "border_ref_pix_left", "border_ref_pix_right", "border_ref_pix_top",
                "border_ref_pix_bottom", "amp33")
MAP_FIELDS = ("data", "data_withsky", "err", "var_poisson", "var_rnoise", "dumo", "chisq")


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).to(device)


def gap(p, r, device="cpu", scale=None):
    """(widest gap, values non-finite on one side or unequal where both
    are, values) of a float field: the gap ``|p - r| / (|r| + m)``, ``m``
    the median of ``|r|`` (or ``|p - r| / scale``), over the values
    finite on both sides; all values where the shapes differ."""
    n = int(np.size(r))
    if np.shape(p) != np.shape(r):
        return 0.0, max(n, 1), max(n, 1)
    if n == 0:
        return 0.0, 0, 0
    p, r = _t(p, device).reshape(-1), _t(r, device).reshape(-1)
    fp, fr = torch.isfinite(p), torch.isfinite(r)
    both = fp & fr
    odd = int((fp != fr).sum()) + int((~fp & ~fr & ~((p == r) | (torch.isnan(p)
                                                             & torch.isnan(r)))).sum())
    p, r = p[both].double(), r[both].double()
    if r.numel() == 0:
        return 0.0, odd, n
    ar = r.abs()
    if scale is None:
        m = float(ar.median())
        den = ar + m if m > 0 else ar.clamp_min(1e-30)
    else:
        den = torch.full_like(ar, max(float(scale), 1e-30))
    return float(((p - r).abs() / den).max()), odd, n


def mismatch(pairs):
    """(values that differ, values) over the (program, reference) pairs
    (all of a pair whose shapes differ)."""
    n = bad = 0
    for p, r in pairs:
        p, r = np.asarray(p), np.asarray(r)
        n += max(r.size, 1)
        bad += max(r.size, 1) if p.shape != r.shape else int(np.count_nonzero(p != r))
    return bad, n


def numbers(tree, ref, device="cpu"):
    """The compared numbers of one call: ``tree`` the program's L2 tree
    (``roman`` and ``processinfo``), ``ref`` the reference's arrays."""
    im, pi = tree["roman"], tree["processinfo"]
    pairs = [(im[k], ref[k]) for k in EXACT_FIELDS]
    if "endslice" in ref or "endslice" in pi:
        pairs.append((pi.get("endslice"), ref.get("endslice")))
    bad, n = mismatch(pairs)
    sc = np.asarray(ref["skycoefs"], np.float32)
    med = float(ref["medsky"])
    fields = [(im[k], ref[k], None) for k in MAP_FIELDS if k in ref] + [
        (pi["skycoefs"], sc, float(np.abs(sc).max()) if sc.size else 1.0),
        ([float(pi["medsky"])], [med], abs(med))]
    widest = 0.0
    for p, r, scale in fields:
        g, odd, m = gap(p, r, device, scale)
        widest, bad, n = max(widest, g), bad + odd, n + m
    return {"exact_frac": bad / n, "maps_gap": widest}


def worst(readings):
    """The largest reading of each number over several calls."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(readings, limits):
    """(correct, [(name, value, limit)]) of the worst readings against
    ``limits``; a number without a limit, or a limit without a number,
    is not correct."""
    rows = [(k, readings.get(k), limits.get(k)) for k in sorted(set(readings) | set(limits))]
    ok = all(v is not None and lim is not None and v <= lim for _, v, lim in rows)
    return ok, rows
