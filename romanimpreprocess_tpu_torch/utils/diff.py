"""CLI group-difference FITS writer (reference ``utils/diff.py:9-19``)."""

import sys

import numpy as np

from ..io import asdf_lite, fits_lite


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if len(argv) < 5:
        print(
            "Calling format: python -m romanimpreprocess_tpu_torch.utils.diff "
            "<asdf in> <fits out> <group1> <group2>"
        )
        return
    f = asdf_lite.open(argv[1])
    data = np.asarray(f["roman"]["data"], np.float32)
    diffimage = data[int(argv[4])] - data[int(argv[3])]
    fits_lite.PrimaryHDU(diffimage).writeto(argv[2], overwrite=True)


if __name__ == "__main__":
    main()
