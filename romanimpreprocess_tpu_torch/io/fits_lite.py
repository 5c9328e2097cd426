"""Minimal FITS image reader/writer (pure numpy).

The reference consumes/produces FITS via astropy (truth images
``sim_to_isim.py:491``, quick-look outputs ``gen_cal_image.py:725-736``,
WCS sidecar headers ``sim_to_isim.py:986-987``).  astropy is not in this
environment, so this module implements the subset needed: primary +
image extension HDUs, standard integer/float BITPIX (with the uint16
BZERO=32768 convention), and an ordered :class:`Header` with 80-char
card serialization compatible with ``fits.Header.fromstring/tofile``.
"""

import numpy as np

BLOCK = 2880

_BITPIX = {
    np.dtype(">u1"): 8,
    np.dtype(">i2"): 16,
    np.dtype(">i4"): 32,
    np.dtype(">i8"): 64,
    np.dtype(">f4"): -32,
    np.dtype(">f8"): -64,
}
_FROM_BITPIX = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4", -64: ">f8"}


class Header:
    """Ordered FITS header: keyword -> value, with comment support."""

    def __init__(self, cards=None):
        self._keys = []
        self._values = {}
        self._comments = {}
        if cards:
            for k, v in cards:
                self[k] = v

    # -- mapping interface -----------------------------------------------
    def __contains__(self, key):
        return key.upper() in self._values

    def __getitem__(self, key):
        return self._values[key.upper()]

    def get(self, key, default=None):
        return self._values.get(key.upper(), default)

    def __setitem__(self, key, value):
        key = key.upper()
        if key not in self._values and key not in ("COMMENT", "HISTORY"):
            self._keys.append(key)
        elif key in ("COMMENT", "HISTORY"):
            self._keys.append(key)
            self._values.setdefault(key, [])
            self._values[key].append(value)
            return
        self._values[key] = value

    def __delitem__(self, key):
        key = key.upper()
        self._keys = [k for k in self._keys if k != key]
        del self._values[key]

    def keys(self):
        return list(self._keys)

    def items(self):
        return [(k, self._values[k]) for k in self._keys]

    def copy(self):
        h = Header()
        h._keys = list(self._keys)
        # COMMENT/HISTORY values are lists that __setitem__ appends to
        # in place — a shallow dict copy would share them, so adding a
        # comment to the copy would mutate the original header too
        h._values = {
            k: (list(v) if isinstance(v, list) else v)
            for k, v in self._values.items()
        }
        h._comments = dict(self._comments)
        return h

    # -- card formatting -------------------------------------------------
    @staticmethod
    def _format_value(v):
        if isinstance(v, bool):
            return "T" if v else "F", True
        if isinstance(v, (int, np.integer)):
            return str(int(v)), True
        if isinstance(v, (float, np.floating)):
            s = repr(float(v))
            if "e" in s or "E" in s:
                m, e = s.split("e") if "e" in s else s.split("E")
                s = f"{m}E{int(e):+03d}"
            elif "." not in s and "inf" not in s and "nan" not in s:
                s += ".0"
            return s, True
        # string value
        s = str(v).replace("'", "''")
        return f"'{s:<8s}'", False

    def _card(self, key, value):
        if key in ("COMMENT", "HISTORY"):
            return f"{key:<8s}{str(value):<72s}"[:80]
        sval, right = self._format_value(value)
        if not right and len(sval) > 70:
            # a string value longer than the card can hold: truncate the
            # VALUE but keep the closing quote (a blind card[:80] slice
            # would drop it, writing a corrupt open-quoted card that
            # readers misparse; astropy warns-and-truncates the same way)
            inner = sval[1:-1][:67]
            if inner.endswith("'") and not inner.endswith("''"):
                inner = inner[:-1]  # don't split an escaped quote pair
            sval = f"'{inner}'"
        if right:
            card = f"{key:<8s}= {sval:>20s}"
        else:
            card = f"{key:<8s}= {sval:<20s}"
        comment = self._comments.get(key)
        # append the comment only if it fits (a sliced-off separator
        # would corrupt the value field for value-type-sniffing readers)
        if comment and len(card) + 3 < 80:
            card += f" / {comment}"
        return f"{card:<80s}"[:80]

    def tostring(self, padding=True):
        cards = []
        seen_multi = set()
        for k in self._keys:
            if k in ("COMMENT", "HISTORY"):
                if k in seen_multi:
                    continue
                seen_multi.add(k)
                for line in self._values[k]:
                    cards.append(self._card(k, line))
            else:
                cards.append(self._card(k, self._values[k]))
        cards.append(f"{'END':<80s}")
        s = "".join(cards)
        if padding and len(s) % BLOCK:
            s += " " * (BLOCK - len(s) % BLOCK)
        return s

    def tofile(self, path, overwrite=True):
        mode = "w" if overwrite else "x"
        with open(path, mode) as f:
            f.write(self.tostring())

    @classmethod
    def fromstring(cls, s):
        h = cls()
        for i in range(0, len(s) - 79, 80):
            card = s[i : i + 80]
            key = card[:8].strip()
            if key == "END":
                break
            if not key:
                continue
            if key in ("COMMENT", "HISTORY") or card[8:10] != "= ":
                if key in ("COMMENT", "HISTORY"):
                    h[key] = card[8:].rstrip()
                continue
            body = card[10:]
            h[key] = _parse_value(body)
        return h


def _parse_value(body):
    body = body.strip()
    if body.startswith("'"):
        # string; find closing quote (doubled quotes escape)
        out = []
        i = 1
        while i < len(body):
            if body[i] == "'":
                if i + 1 < len(body) and body[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(body[i])
            i += 1
        return "".join(out).rstrip()
    val = body.split("/")[0].strip()
    if val == "T":
        return True
    if val == "F":
        return False
    try:
        return int(val)
    except ValueError:
        pass
    try:
        return float(val.replace("D", "E"))
    except ValueError:
        return val


class HDU:
    """One FITS HDU: header + image data (or None)."""

    def __init__(self, data=None, header=None, name=None):
        self.data = data
        self.header = header if header is not None else Header()
        if name is not None:
            self.header["EXTNAME"] = name

    def writeto(self, path, overwrite=True):
        write(path, [self], overwrite=overwrite)


def PrimaryHDU(data=None, header=None):
    return HDU(data=data, header=header)


def ImageHDU(data=None, header=None, name=None):
    return HDU(data=data, header=header, name=name)


class HDUList(list):
    def writeto(self, path, overwrite=True):
        write(path, self, overwrite=overwrite)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _encode_hdu(hdu, primary):
    data = hdu.data
    h = Header()
    bzero = 0
    if data is not None:
        data = np.asarray(data)
        if data.dtype == np.uint16:
            data = (data.astype(np.int32) - 32768).astype(">i2")
            bzero = 32768
        elif data.dtype == np.uint32:
            data = (data.astype(np.int64) - 2147483648).astype(">i4")
            bzero = 2147483648
        elif data.dtype == np.bool_ or data.dtype == np.int8:
            data = data.astype(">u1")
        elif data.dtype == np.float16:
            data = data.astype(">f4")
        else:
            data = data.astype(data.dtype.newbyteorder(">"))
    if primary:
        h["SIMPLE"] = True
    else:
        h["XTENSION"] = "IMAGE"
    h["BITPIX"] = _BITPIX[data.dtype] if data is not None else 8
    h["NAXIS"] = data.ndim if data is not None else 0
    if data is not None:
        for i, n in enumerate(reversed(data.shape)):
            h[f"NAXIS{i + 1}"] = int(n)
    if not primary:
        h["PCOUNT"] = 0
        h["GCOUNT"] = 1
    if bzero:
        h["BSCALE"] = 1
        h["BZERO"] = int(bzero)
    # append user cards (skipping structural ones)
    skip = {"SIMPLE", "XTENSION", "BITPIX", "NAXIS", "PCOUNT", "GCOUNT",
            "BSCALE", "BZERO", "END"} | {f"NAXIS{i}" for i in range(1, 10)}
    for k in hdu.header.keys():
        if k in skip:
            continue
        if k in ("COMMENT", "HISTORY"):
            for line in hdu.header._values[k]:
                h._keys.append(k)
                h._values.setdefault(k, [])
                h._values[k].append(line)
            continue
        h[k] = hdu.header[k]
    out = h.tostring().encode("ascii")
    if data is not None:
        raw = data.tobytes()
        pad = (-len(raw)) % BLOCK
        out += raw + b"\x00" * pad
    return out


def write(path, hdus, overwrite=True):
    if isinstance(hdus, HDU):
        hdus = [hdus]
    with open(path, "wb") as f:
        for i, hdu in enumerate(hdus):
            f.write(_encode_hdu(hdu, primary=(i == 0)))


def _apply_scaling(data, bitpix, bzero, bscale):
    """FITS BZERO/BSCALE decode (incl. the unsigned-int conventions)."""
    if bzero == 32768 and bitpix == 16:
        return (data.astype(np.int32) + 32768).astype(np.uint16)
    if bzero == 2147483648 and bitpix == 32:
        return (data.astype(np.int64) + 2147483648).astype(np.uint32)
    if bzero != 0 or bscale != 1:
        return data * bscale + bzero
    return data.astype(data.dtype.newbyteorder("="))


class _ScaledView:
    """Lazy BZERO/BSCALE-decoded view over a memory-mapped data section.

    Slicing reads only the touched pages and decodes just that slice —
    astropy's lazy-``.data`` behavior, which the calibration tools
    rely on to stream multi-GB dark ramp cubes group by group
    (reference ``make_dark_file.py:53-69`` iterates groups over ~100
    files; eager reads would re-read every file once per group).
    """

    def __init__(self, raw, bitpix, bzero, bscale):
        self._raw = raw
        self._bitpix = bitpix
        self._bzero = bzero
        self._bscale = bscale
        self.shape = raw.shape
        self.ndim = raw.ndim

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, idx):
        return _apply_scaling(
            np.asarray(self._raw[idx]), self._bitpix, self._bzero,
            self._bscale,
        )

    def __array__(self, dtype=None, copy=None):
        out = _apply_scaling(
            np.asarray(self._raw), self._bitpix, self._bzero, self._bscale
        )
        return out.astype(dtype) if dtype is not None else out


def open_fits(path, memmap=False):
    """Read all image HDUs from a FITS file. Returns an HDUList.

    With ``memmap=True`` the data sections are memory-mapped and each
    HDU's ``.data`` is a :class:`_ScaledView` — indexing decodes only
    the requested slice, so group-sliced reads of large ramp cubes
    touch only their pages.
    """
    if memmap:
        buf = np.memmap(path, dtype=np.uint8, mode="r")
        size = buf.size
    else:
        with open(path, "rb") as f:
            buf = f.read()
        size = len(buf)
    hdus = HDUList()
    pos = 0
    while pos + BLOCK <= size:
        # read header blocks until END card
        htext = ""
        end_found = False
        while pos + BLOCK <= size and not end_found:
            block = bytes(buf[pos : pos + BLOCK]).decode("ascii", "replace")
            pos += BLOCK
            htext += block
            for i in range(0, BLOCK, 80):
                if block[i : i + 3] == "END" and block[i : i + 8].strip() == "END":
                    end_found = True
                    break
        if not htext.strip():
            break
        header = Header.fromstring(htext)
        bitpix = header.get("BITPIX", 8)
        naxis = header.get("NAXIS", 0)
        shape = tuple(
            int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1)
        )
        data = None
        if naxis > 0 and all(shape):
            dt = np.dtype(_FROM_BITPIX[bitpix])
            nbytes = int(np.prod(shape)) * dt.itemsize
            bzero = header.get("BZERO", 0)
            bscale = header.get("BSCALE", 1)
            if memmap:
                raw = buf[pos : pos + nbytes].view(dt).reshape(shape)
                data = _ScaledView(raw, bitpix, bzero, bscale)
            else:
                raw = np.frombuffer(buf[pos : pos + nbytes], dtype=dt
                                    ).reshape(shape)
                data = _apply_scaling(raw, bitpix, bzero, bscale)
            pos += nbytes + ((-nbytes) % BLOCK)
        hdus.append(HDU(data=data, header=header))
    return hdus
