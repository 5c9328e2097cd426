"""Kernels: the linearity step's share (%) of the card's bandwidth bound."""

from gpubench.readers import linearity_roofline_pct as read  # noqa: F401
