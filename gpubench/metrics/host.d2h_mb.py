"""Host driver: MB per SCA on the program's ``d2h_bytes`` counter."""

from gpubench.program_spans import host_d2h_mb as read  # noqa: F401
