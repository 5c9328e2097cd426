"""Staging: share (%) of the staging caches' lookups that hit, from the program's counters."""

from gpubench.program_spans import staging_hit_pct as read  # noqa: F401
