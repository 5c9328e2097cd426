"""Host driver: wall ms of ``prepare_inputs`` per SCA, less the staging inside it."""

from gpubench.readers import host_prepare_ms as read  # noqa: F401
