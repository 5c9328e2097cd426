"""Focal-plane mosaic plots of calibration-file quantities.

Equivalent of the reference's ``utils/fpaplot.py:31-372``: reads a
quantity (gain, IPC alphas, linearity coefficients, normalized p-flat,
read noise) from each SCA's calibration file, bins and masks it, and
composites the 18 SCAs at their physical focal-plane positions into an
RGB image with a color bar; ``multi_image`` tiles the standard 8-panel
QA sheet.  Text is rendered with PIL's built-in bitmap font (the
reference ships its own ``letters.dat`` bitmap table).
"""

import os
import sys

import numpy as np

from ..io import asdf_lite

#: Focal-plane SCA center positions in units of pixels (0.01 mm),
#: WFI01..WFI18 (instrument geometry; same table as the reference).
nside_base = 4096
ctrs = np.array(
    [
        [2214, 1215], [2229, -3703], [2244, -8206],
        [6642, 2090], [6692, -2828], [6742, -7306],
        [11070, 4220], [11148, -698], [11264, -5106],
        [-2214, 1215], [-2229, -3703], [-2244, -8206],
        [-6642, 2090], [-6692, -2828], [-6742, -7306],
        [-11070, 4220], [-11148, -698], [-11264, -5106],
    ],
    dtype=np.int64,
)
bbox = {"xmin": -13312, "xmax": 13312, "ymin": -10254, "ymax": 6268}

#: quantity -> (cal file type, leading index into the data array)
PTYPE = {
    "gain": ("gain", None),
    "alphaH": ("ipc4d", (1, 0)),
    "alphaV": ("ipc4d", (0, 1)),
    "alphaD": ("ipc4d", (0, 0)),
    "lin2": ("linearitylegendre", (2,)),
    "lin3": ("linearitylegendre", (3,)),
    "pflatnorm": ("pflat", None),
    "read": ("read", None),
}

LABELS = {
    "gain": "gain (e/DN)",
    "alphaH": "IPC_h",
    "alphaV": "IPC_v",
    "alphaD": "IPC_d",
    "lin2": "c2 (DN)",
    "lin3": "c3 (DN)",
    "pflatnorm": "pflatnorm",
    "read": "rn (DN)",
}


def read_sca_image(infile_format, n1, ptype, scanum, mask=None):
    """(n1, n1) masked, bin-averaged image of one quantity on one SCA.

    ``infile_format.format(filetype, scanum)`` locates the file; absent
    files return zeros (so partial focal planes still plot).
    """
    ftype, lead = PTYPE[ptype]
    path = infile_format.format(ftype, scanum)
    if not os.path.exists(path):
        return np.zeros((n1, n1))
    obj = np.asarray(asdf_lite.open(path)["roman"]["data"])
    if lead is not None:
        for i in lead:
            obj = obj[i]
    obj = obj.astype(np.float64)

    if mask is not None:
        mpath = infile_format.format("mask", scanum)
        if os.path.exists(mpath):
            dq = asdf_lite.open(mpath)["roman"]["dq"]
            m = mask.build(np.asarray(dq)).numpy()
            # active-region arrays (e.g. the IPC kernel) are narrower
            # than the full-frame mask: pad to match before masking
            pad = (m.shape[0] - obj.shape[0]) // 2
            if pad > 0:
                obj = np.pad(obj, pad)
            obj = np.where(~m, obj, np.nan)

    # pad to the nearest multiple of n1 (full frame, or the reduced
    # geometry of small synthetic cal sets), then bin-average to (n1, n1)
    base = ((max(obj.shape[0], n1) + n1 - 1) // n1) * n1
    pad = (base - obj.shape[0]) // 2
    if pad > 0 or obj.shape[0] < base:
        obj = np.pad(
            obj, ((pad, base - obj.shape[0] - pad),) * 2,
            constant_values=np.nan,
        )
    k = base // n1
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmean(obj.reshape(n1, k, n1, k), axis=(1, 3))


def write_text(image, origin, size, val, string):
    """Write text into a 2-D uint8 image plane using PIL's bitmap font.

    Glyphs are rendered at the font's native ~6x12 cell, scaled by
    ``size`` with nearest-neighbour, and pre-flipped vertically so they
    read upright after the panel's final ``arr[::-1]`` save (the
    reference pre-flips its bitmap font the same way,
    ``fpaplot.py:150-182`` ``letters[ord(c), ::-1, :]``).
    """
    from PIL import Image, ImageDraw, ImageFont

    bw, bh = 6 * max(len(string), 1), 12
    txt = Image.new("L", (bw, bh), 0)
    draw = ImageDraw.Draw(txt)
    draw.text((0, 0), string, fill=255, font=ImageFont.load_default())
    h, w = bh * size, bw * size
    card = np.asarray(
        txt.resize((w, h), Image.NEAREST), dtype=np.uint8
    )[::-1]
    y0, x0 = origin
    y1 = min(y0 + h, image.shape[-2])
    x1 = min(x0 + w, image.shape[-1])
    if y1 <= y0 or x1 <= x0:
        return
    sub = card[: y1 - y0, : x1 - x0]
    image[y0:y1, x0:x1] = np.where(sub > 0, val, image[y0:y1, x0:x1])


def make_big_image(infile_format, n1, ptype, vmin=0.0, vmax=1.0, mask=None,
                   cmap="viridis", scaleformat=None):
    """RGB uint8 mosaic of the full 18-SCA focal plane for one quantity."""
    import matplotlib

    scale = nside_base // n1
    nx = (bbox["xmax"] - bbox["xmin"] + 1) // scale
    ny = (bbox["ymax"] - bbox["ymin"] + 1) // scale
    arr = np.full((ny, nx, 3), 255, dtype=np.uint8)
    cm = matplotlib.colormaps[cmap]

    for scanum in range(1, 19):
        img = read_sca_image(infile_format, n1, ptype, scanum, mask=mask)
        if ptype == "pflatnorm":
            img = img / (np.nanmedian(img) + 1e-24)
        img = np.nan_to_num(img, nan=0.0)
        img = np.clip((img - vmin) / (vmax - vmin), 0.0, 1.0)
        posx = (ctrs[scanum - 1, 0] - nside_base // 2 - bbox["xmin"]) // scale
        posy = (ctrs[scanum - 1, 1] - nside_base // 2 - bbox["ymin"]) // scale
        arr[posy : posy + n1, posx : posx + n1, :] = cm(img, bytes=True)[:, :, :3]

    if scaleformat is not None:
        _annotate_scale(arr, cm, vmin, vmax, n1, scaleformat,
                        LABELS[ptype])

    return arr


def _annotate_scale(arr, cm, vmin, vmax, n1, scaleformat, label):
    """Panel footer: quantity label, color bar, tick notches, tick
    values — stacked top-to-bottom in the SAVED image (the panel is
    flipped vertically on save, so the band lives in ``arr``'s last
    rows and is laid out bottom-up here).

    All positions derive from three named quantities (glyph scale, bar
    thickness, line pitch); the band reuses the empty focal-plane
    corner the reference's panels also annotate into, but the layout
    itself is this repo's own (ticks are centered notches under the
    bar, values centered under their notch).
    """
    ny, nx, _ = arr.shape
    sc = max(n1 // 64, 1)       # glyph scale (write_text cell = 6x12)
    glyph_h, glyph_w = 12 * sc, 6 * sc
    bar_h = max(n1 // 8, 2)     # color-bar thickness
    bar_w = 2 * n1              # color-bar length
    pitch = glyph_h + 3 * sc    # text line pitch inside the band
    notch = 2 * sc              # tick-notch drop below the bar

    xbar = (nx - bar_w) // 2
    ybar = ny - pitch - bar_h   # label line sits above (image-wise)
    arr[ybar : ybar + bar_h, xbar : xbar + bar_w, :] = cm(
        np.linspace(0.0, 1.0, bar_w), bytes=True
    )[None, :, :3]

    for frac in (0.0, 0.5, 1.0):
        xt = xbar + int(frac * (bar_w - 1))
        arr[ybar - notch : ybar, xt : xt + sc, :] = 0
        txt = scaleformat.format(vmin + frac * (vmax - vmin))
        xt0 = int(np.clip(xt - glyph_w * len(txt) // 2, 0, nx - 1))
        for ch in range(3):
            write_text(arr[:, :, ch], (ybar - notch - glyph_h, xt0),
                       sc, 0, txt)

    x0 = max(0, (nx - glyph_w * len(label)) // 2)
    for ch in range(3):
        write_text(arr[:, :, ch], (ny - glyph_h, x0), sc, 0, label)


def multi_image(infile_format, n1, masktype):
    """Standard 8-panel QA sheet: lin2/lin3, gain, alphaD/H/V,
    pflatnorm, read noise (reference ``multi_image:278-358``)."""
    panels = [
        ("lin2", -100.0, 2900.0, "{:4.0f}"),
        ("lin3", -100.0, 1500.0, "{:4.0f}"),
        ("gain", 1.2, 2.1, "{:4.2f}"),
        ("alphaD", 0.0, 0.004, "{:5.3f}"),
        ("alphaH", 0.005, 0.025, "{:5.3f}"),
        ("alphaV", 0.005, 0.025, "{:5.3f}"),
        ("pflatnorm", 0.8, 1.2, "{:4.2f}"),
        ("read", 4.0, 9.0, "{:4.1f}"),
    ]
    images = [
        make_big_image(infile_format, n1, p, vmin=lo, vmax=hi,
                       scaleformat=fmt, mask=masktype)
        for p, lo, hi, fmt in panels
    ]
    return _tile_grid(images, ncols=2, gap=1 + n1 // 4)


def _tile_grid(images, ncols, gap, background=255):
    """Composite equal-shaped RGB panels into an ``ncols``-wide grid by
    concatenation with background-colored spacer strips (a short row is
    padded with blank panels)."""
    blank = np.full_like(images[0], background)
    vgap = np.full((images[0].shape[0], gap, 3), background, np.uint8)
    rows = []
    for r in range(0, len(images), ncols):
        row = list(images[r : r + ncols])
        row += [blank] * (ncols - len(row))
        parts = []
        for j, img in enumerate(row):
            parts += ([vgap] if j else []) + [img]
        rows.append(np.concatenate(parts, axis=1))
    hgap = np.full((gap, rows[0].shape[1], 3), background, np.uint8)
    parts = []
    for i, rowimg in enumerate(rows):
        parts += ([hgap] if i else []) + [rowimg]
    return np.concatenate(parts, axis=0)


def main(argv=None):
    from PIL import Image

    from ..ops.mask import PixelMask1

    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--selftest":
        # CI artifact mode: render the panel from a synthetic cal set
        # (reference CI uploads its FPA panel the same way,
        # testing-and-coverage.yml:52-63)
        import tempfile

        from ..synth import make_cal_files

        d = tempfile.mkdtemp()
        rp = [[0], [1, 2], [3, 4, 5], [6, 7, 8], [9, 10]]
        for sca in (1, 4, 9):
            make_cal_files(d + "/roman_wfi", rp, nside=128, seed=sca,
                           tag="CI", sca=sca)
        fmt = d + "/roman_wfi_{:s}_CI_SCA{:02d}.asdf"
        arr = multi_image(fmt, 16, PixelMask1)
        Image.fromarray(arr[::-1, :, :]).save(argv[1])
        return
    arr = multi_image(argv[0], 128, PixelMask1)
    Image.fromarray(arr[::-1, :, :]).save(argv[1])


if __name__ == "__main__":
    main()
