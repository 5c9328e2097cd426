"""Host I/O: ASDF/FITS readers and writers, CALDIR loading."""

from . import asdf_lite, fits_lite  # noqa: F401
