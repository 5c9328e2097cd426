"""Host driver: thousands of minor page faults per SCA in the program's host spans."""

from gpubench.program_spans import host_faults_k as read  # noqa: F401
