"""Row geometry of a slab of one frame's rows.

A slab holds rows ``[y0, y0 + n)`` of an ``nside``-row frame; its first
``lo`` and last ``hi`` rows are halo (a neighbouring slab's own rows,
read by the stencils and then trimmed).  The frame's active region is
its rows and columns ``[nborder, nside - nborder)``.  Every layer that
cuts or reads a slab (the IPC kernels' row form, the row-sharded
calibration core, :mod:`..parallel.spatial`) asks this module which of
the slab's rows are its own and which are active.  The whole frame is
``Rows(0, nside)``.
"""

from typing import NamedTuple


class Rows(NamedTuple):
    """Rows ``[y0, y0 + n)`` of the frame, the first ``lo`` and the last
    ``hi`` of them halo."""

    y0: int
    n: int
    lo: int = 0
    hi: int = 0

    @property
    def own(self):
        """The slab's own rows, as a local slice."""
        return slice(self.lo, self.n - self.hi)

    def trimmed(self):
        """The slab's own rows, without the halo."""
        return Rows(self.y0 + self.lo, self.n - self.lo - self.hi)

    def active(self, nside, nborder):
        """Local slice of the rows (halo included) that are active rows
        of the frame."""
        a0 = min(max(nborder - self.y0, 0), self.n)
        return slice(a0, max(min(nside - nborder - self.y0, self.n), a0))

    def own_active(self, nside, nborder):
        """Local slice of the own rows that are active rows of the frame."""
        a = self.active(nside, nborder)
        a0 = min(max(a.start, self.lo), self.n - self.hi)
        return slice(a0, max(min(a.stop, self.n - self.hi), a0))

    def active_span(self, nside, nborder):
        """The rows of :meth:`active`, counted from the active region's
        first row (their rows of an active-height array)."""
        a = max(self.y0, nborder) - nborder
        return slice(a, max(min(self.y0 + self.n, nside - nborder) - nborder, a))

    def checked(self, nside, nborder):
        """``self``, or ValueError if the halo leaves no own rows or the
        border no active region."""
        if self.lo < 0 or self.hi < 0 or self.lo + self.hi >= self.n:
            raise ValueError(f"halo {self.lo} + {self.hi} leaves no own rows "
                             f"in a slab of {self.n}")
        if nborder < 0 or 2 * nborder >= nside:
            raise ValueError(f"nborder {nborder} leaves no active region in nside {nside}")
        return self


def split_rows(nside, n, halo):
    """The frame's rows cut into ``n`` slabs as even as they go (the
    first ``nside % n`` one row longer): each slab's :class:`Rows` with
    ``halo`` rows of its neighbours above and below where it has them."""
    if not 1 <= n <= nside:
        raise ValueError(f"cannot cut {nside} rows into {n} slabs")
    base, extra = divmod(nside, n)
    out, o0 = [], 0
    for i in range(n):
        o1 = o0 + base + (1 if i < extra else 0)
        lo, hi = min(halo, o0), min(halo, nside - o1)
        out.append(Rows(o0 - lo, o1 - o0 + lo + hi, lo, hi))
        o0 = o1
    return out
