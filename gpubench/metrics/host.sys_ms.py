"""Host driver: system CPU ms per SCA in the program's host spans (faulting in fresh buffers)."""

from gpubench.program_spans import host_sys_ms as read  # noqa: F401
