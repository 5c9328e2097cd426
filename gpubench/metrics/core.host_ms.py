"""Device core: host wall ms per SCA inside the program's ``l1_to_l2.<stage>`` spans."""

from gpubench.program_spans import core_host_ms as read  # noqa: F401
