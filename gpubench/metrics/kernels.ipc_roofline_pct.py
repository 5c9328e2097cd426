"""Kernels: the IPC inverse's share (%) of the card's bandwidth bound."""

from gpubench.readers import ipc_roofline_pct as read  # noqa: F401
