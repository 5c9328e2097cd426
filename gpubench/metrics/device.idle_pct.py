"""Device: share (%) of the traced window in which no kernel runs."""

from gpubench.readers import device_idle_pct as read  # noqa: F401
