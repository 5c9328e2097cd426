"""Staging: MB per SCA on the program's ``h2d_bytes`` counter."""

from gpubench.program_spans import staging_staged_mb as read  # noqa: F401
