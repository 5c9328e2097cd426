"""Context manager for report figures (Agg backend, optional TeX).

Equivalent of the reference's ``utils/context_figure.py``: switches to
the Agg backend inside the context and restores the environment backend
on exit.  TeX rendering is attempted only when a latex binary is
available (the reference unconditionally sets ``usetex=True``; its CI
installs TeX Live — this environment may not have it).
"""

import shutil


class ReportFigContext:
    def __init__(self, mpl, plt, usetex=None):
        self.mpl = mpl
        self.plt = plt
        self.want_usetex = (
            shutil.which("latex") is not None if usetex is None else usetex
        )

    def __enter__(self):
        self.env_backend = self.mpl.get_backend()
        self.usetex = self.plt.rcParams.get("text.usetex", None)
        self.mpl.use("Agg")
        self.plt.switch_backend("Agg")
        self.plt.rcParams["text.usetex"] = self.want_usetex
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.mpl.use(self.env_backend)
        self.plt.switch_backend(self.env_backend)
        if self.usetex is not None:
            self.plt.rcParams["text.usetex"] = self.usetex
        return False
