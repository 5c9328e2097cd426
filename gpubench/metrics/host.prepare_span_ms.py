"""Host driver: wall ms of the program's ``host.prepare`` span per SCA, less its staging spans."""

from gpubench.program_spans import host_prepare_span_ms as read  # noqa: F401
