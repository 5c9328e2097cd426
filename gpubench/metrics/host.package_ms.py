"""Host driver: wall ms of ``to_host`` + ``package_tree`` + ``typefix.fix`` per SCA."""

from gpubench.readers import host_package_ms as read  # noqa: F401
