"""String-accumulator processing log embedded in pipeline outputs.

Equivalent of the reference's ``utils/processlog.py:12-56``; the full
text lands in the L2 tree (``processinfo['log']``) for provenance.
Adds optional wall-clock stage stamps (the reference has no timing
instrumentation; SURVEY.md §5 calls for structured stage timings here).
"""

import time


class ProcessLog:
    def __init__(self, timestamps=False):
        self.output = ""
        self.reffiles = {}
        self._timestamps = timestamps
        self._t0 = time.monotonic()

    def append(self, text):
        if self._timestamps:
            text = f"[{time.monotonic() - self._t0:9.3f}s] {text}"
        self.output += text

    def __str__(self):
        return self.output
