"""Staging: wall ms inside ``stage``, ``ipc_precal``, ``kernel_planes_frame`` per SCA."""

from gpubench.readers import staging_ms as read  # noqa: F401
