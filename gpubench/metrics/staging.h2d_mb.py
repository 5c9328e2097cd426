"""Staging: host-to-device MB per SCA, from the trace's memcpy records."""

from gpubench.readers import staging_h2d_mb as read  # noqa: F401
