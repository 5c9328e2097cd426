"""Host driver: wall ms of the program's ``host.to_host``, ``host.package``, ``host.typefix`` spans per SCA."""

from gpubench.program_spans import host_package_span_ms as read  # noqa: F401
