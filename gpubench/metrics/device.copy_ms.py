"""Device: device ms of the memcopies and memsets per SCA, both ways."""

from gpubench.readers import device_copy_ms as read  # noqa: F401
