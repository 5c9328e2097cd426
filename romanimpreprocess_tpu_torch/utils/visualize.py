"""L1 cutout filmstrip visualization.

Equivalent of the reference's ``utils/visualize.py:16-119``: renders a
cutout of every group of an L1 cube plus the differences against group
1 (percentile scaling; PowerNorm for the accumulated-signal panels)
into a PDF.
"""

import sys

import numpy as np

from ..io import asdf_lite
from .context_figure import ReportFigContext


def visualize(argv):
    """argv: [dummy, infile.asdf, "xmin,xmax,ymin,ymax", out.pdf,
    percentile_cut (optional)]."""
    if len(argv) < 4:
        print(
            "Calling format: python -m romanimpreprocess_tpu_torch.utils.visualize "
            "infile.asdf xmin,xmax,ymin,ymax outfile.pdf [percentile_cut]"
        )
        return

    import matplotlib
    import matplotlib.colors as colors
    import matplotlib.pyplot as plt

    xmin, xmax, ymin, ymax = (int(v) for v in argv[2].split(","))
    f = asdf_lite.open(argv[1])
    data = np.asarray(
        f["roman"]["data"][:, ymin : ymax + 1, xmin : xmax + 1], np.float32
    )
    ng = data.shape[0]
    percentile_cut = float(argv[4]) if len(argv) > 4 else 2.0

    with ReportFigContext(matplotlib, plt):
        matplotlib.rcParams.update({"font.size": 8})
        fig = plt.figure(figsize=(3.5 * ng, 6))

        vmin = np.percentile(data, percentile_cut)
        vmax = np.percentile(data, 100 - percentile_cut)
        for j in range(ng):
            ax = fig.add_subplot(2, ng, 1 + j)
            ax.set_title(f"Group {j}")
            ax.set_xlabel(f"x-{xmin}")
            ax.set_ylabel(f"y-{ymin}")
            im = ax.imshow(
                data[j], cmap="magma", aspect=1.0, interpolation="nearest",
                origin="lower", vmin=vmin, vmax=vmax,
            )
            fig.colorbar(im, orientation="vertical", fraction=0.046, pad=0.04)

        diff = data - data[1][None]
        ax = fig.add_subplot(2, ng, ng + 1)
        ax.set_title("Grp0-Grp1")
        ax.set_xlabel(f"x-{xmin}")
        ax.set_ylabel(f"y-{ymin}")
        im = ax.imshow(
            diff[0], cmap="magma", aspect=1.0, interpolation="nearest",
            origin="lower",
            vmin=np.percentile(diff[0], percentile_cut),
            vmax=np.percentile(diff[0], 100 - percentile_cut),
        )
        fig.colorbar(im, orientation="vertical", fraction=0.046, pad=0.04)

        vmax = np.percentile(diff[-1], 100 - percentile_cut)
        vmin = -0.05 * vmax
        for j in range(2, ng):
            ax = fig.add_subplot(2, ng, ng + 1 + j)
            ax.set_title(f"Grp{j}-Grp1")
            ax.set_xlabel(f"x-{xmin}")
            ax.set_ylabel(f"y-{ymin}")
            im = ax.imshow(
                diff[j], cmap="magma", aspect=1.0, interpolation="nearest",
                origin="lower",
                norm=colors.PowerNorm(gamma=2.0 / 3.0, vmin=vmin, vmax=vmax),
            )
            fig.colorbar(im, orientation="vertical", fraction=0.046, pad=0.04)

        fig.set_tight_layout(True)
        fig.savefig(argv[3])
        plt.close(fig)


if __name__ == "__main__":
    visualize(sys.argv)
