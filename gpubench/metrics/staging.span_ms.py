"""Staging: wall ms of the program's staging spans per SCA, nested ones once."""

from gpubench.program_spans import staging_span_ms as read  # noqa: F401
