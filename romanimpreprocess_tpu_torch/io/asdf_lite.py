"""Minimal ASDF 1.0 reader/writer (pure numpy + PyYAML).

The reference pipeline is file-mediated through ASDF trees (cal files,
L1/L2 products; e.g. ``gen_cal_image.py:712-723``).  This environment has
no ``asdf`` package, so this module implements the functional subset of
the ASDF on-disk format the framework needs:

* nested dict/list/scalar trees serialized as YAML,
* ``!core/ndarray-1.0.0`` nodes backed by uncompressed binary blocks,
* round-trip of all numpy dtypes used by the pipeline
  (uint8/16/32, int8/16/32, float16/32/64, bool, complex64/128).

Files written here follow the public ASDF 1.0 block layout (magic
``\\xd3BLK``, 48-byte block header) so they are readable by the standard
``asdf`` library, and vice versa for files the standard library writes
with uncompressed blocks.

API is intentionally asdf-like::

    with asdf_lite.open(path) as f:
        arr = f["roman"]["data"][...]
    asdf_lite.AsdfFile({"roman": {...}}).write_to(path)
"""

import io as _io
import re as _re
import struct

import numpy as np
import yaml

BLOCK_MAGIC = b"\xd3BLK"
HEADER_LINES = (
    b"#ASDF 1.0.0\n"
    b"#ASDF_STANDARD 1.5.0\n"
    b"%YAML 1.1\n"
    b"%TAG ! tag:stsci.edu:asdf/\n"
)
NDARRAY_TAG = "tag:stsci.edu:asdf/core/ndarray-1.0.0"
ASDF_TAG = "tag:stsci.edu:asdf/core/asdf-1.1.0"
SOFTWARE_TAG = "tag:stsci.edu:asdf/core/software-1.0.0"

# ASDF datatype name <-> numpy dtype
_DTYPES = {
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "uint8": np.uint8,
    "uint16": np.uint16,
    "uint32": np.uint32,
    "uint64": np.uint64,
    "float16": np.float16,
    "float32": np.float32,
    "float64": np.float64,
    "complex64": np.complex64,
    "complex128": np.complex128,
    "bool8": np.bool_,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


class _NDArrayPlaceholder:
    """Unresolved ndarray node (block `source` index + dtype/shape)."""

    def __init__(self, node):
        self.source = node.get("source")
        self.datatype = node.get("datatype")
        self.byteorder = node.get("byteorder", "little")
        self.shape = tuple(node.get("shape", ()))
        self.offset = int(node.get("offset", 0))
        self.inline_data = node.get("data")

    def resolve(self, blocks):
        if self.inline_data is not None:
            return np.asarray(self.inline_data, dtype=_DTYPES[self.datatype])
        dt = np.dtype(_DTYPES[self.datatype])
        dt = dt.newbyteorder("<" if self.byteorder == "little" else ">")
        buf = blocks[self.source]
        n = int(np.prod(self.shape)) if self.shape else 1
        arr = np.frombuffer(buf, dtype=dt, count=n, offset=self.offset)
        arr = arr.reshape(self.shape)
        if self.byteorder != "little":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        return arr


def _make_loader():
    class Loader(yaml.SafeLoader):
        pass

    def _ndarray(loader, node):
        return _NDArrayPlaceholder(loader.construct_mapping(node, deep=True))

    def _any_map(loader, node):
        return loader.construct_mapping(node, deep=True)

    def _any_seq(loader, node):
        return loader.construct_sequence(node, deep=True)

    def _any_scalar(loader, node):
        return loader.construct_scalar(node)

    # prefix-match every core/ndarray-* schema version: standard-asdf
    # writers tag arrays with whatever version their ASDF standard
    # pins (1.0.0 here, 1.1.0 in asdf-standard 1.6), and an unmatched
    # version would fall through to the plain-dict fallback below —
    # silently replacing the array with its metadata mapping
    Loader.add_multi_constructor(
        "tag:stsci.edu:asdf/core/ndarray-",
        lambda loader, suffix, node: _ndarray(loader, node),
    )
    # Unknown asdf tags (asdf-1.1.0 root, software, history entries, units...)
    # degrade gracefully to plain containers.
    Loader.add_multi_constructor(
        "tag:stsci.edu:asdf/",
        lambda loader, suffix, node: _construct_any(loader, node),
    )
    Loader.add_multi_constructor(
        "tag:", lambda loader, suffix, node: _construct_any(loader, node)
    )

    def _construct_any(loader, node):
        if isinstance(node, yaml.MappingNode):
            return loader.construct_mapping(node, deep=True)
        if isinstance(node, yaml.SequenceNode):
            return loader.construct_sequence(node, deep=True)
        return loader.construct_scalar(node)

    return Loader


def _resolve(tree, blocks):
    if isinstance(tree, _NDArrayPlaceholder):
        return tree.resolve(blocks)
    if isinstance(tree, dict):
        return {k: _resolve(v, blocks) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_resolve(v, blocks) for v in tree]
    return tree


def _read_blocks(data, pos):
    """Parse consecutive binary blocks starting at byte offset `pos`."""
    blocks = []
    n = len(data)
    while pos < n and data[pos : pos + 4] == BLOCK_MAGIC:
        pos += 4
        (hsize,) = struct.unpack(">H", data[pos : pos + 2])
        pos += 2
        header = data[pos : pos + hsize]
        pos += hsize
        flags, comp, alloc, used, _dsize = struct.unpack(">I4sQQQ", header[:32])
        if comp.strip(b"\x00"):
            raise NotImplementedError(f"compressed asdf block ({comp!r})")
        blocks.append(data[pos : pos + used])
        pos += alloc
    return blocks


class AsdfFile:
    """In-memory ASDF tree with read/write support."""

    def __init__(self, tree=None):
        self.tree = tree if tree is not None else {}

    def __getitem__(self, key):
        return self.tree[key]

    def __setitem__(self, key, value):
        self.tree[key] = value

    def __contains__(self, key):
        return key in self.tree

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self):
        pass

    # -- writing ---------------------------------------------------------
    def write_to(self, target):
        """Write to a path or file object, streaming binary blocks
        (no intermediate full-file buffer; L1 cubes are ~400 MB)."""
        if hasattr(target, "write"):
            self._write_stream(target)
        else:
            with _io.open(target, "wb") as f:
                self._write_stream(f)

    def _write_stream(self, out):
        ydoc, arrays = self._yaml_and_arrays()
        out.write(HEADER_LINES)
        out.write(ydoc.encode("utf-8"))
        out.write(b"...\n")
        for a in arrays:
            raw = memoryview(a).cast("B")
            out.write(BLOCK_MAGIC)
            out.write(struct.pack(">H", 48))
            header = struct.pack(
                ">I4sQQQ", 0, b"\x00" * 4, len(raw), len(raw), len(raw)
            )
            header += b"\x00" * 16  # md5 omitted (all-zero = unchecked)
            out.write(header)
            out.write(raw)

    def _serialize(self):
        buf = _io.BytesIO()
        self._write_stream(buf)
        return buf.getvalue()

    def _yaml_and_arrays(self):
        arrays = []

        def _encode(obj):
            if isinstance(obj, np.ndarray):
                a = np.ascontiguousarray(obj)
                if a.dtype == np.bool_:
                    name = "bool8"
                else:
                    name = _DTYPE_NAMES[a.dtype.newbyteorder("=")]
                if a.dtype.byteorder == ">":
                    a = a.astype(a.dtype.newbyteorder("<"))
                arrays.append(a)
                return _TaggedMap(
                    NDARRAY_TAG,
                    {
                        "source": len(arrays) - 1,
                        "datatype": name,
                        "byteorder": "little",
                        "shape": list(a.shape),
                    },
                )
            if isinstance(obj, np.generic):
                return obj.item()
            if isinstance(obj, dict):
                return {str(k): _encode(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return [_encode(v) for v in obj]
            return obj

        doc = {
            "asdf_library": _TaggedMap(
                SOFTWARE_TAG,
                {
                    "author": "romanimpreprocess_tpu_torch",
                    "name": "asdf_lite",
                    "version": "1.0",
                },
            ),
        }
        doc.update(_encode(self.tree))

        dumper = _make_dumper()
        ydoc = yaml.dump(
            doc,
            Dumper=dumper,
            default_flow_style=False,
            allow_unicode=True,
            explicit_start=True,
            sort_keys=False,
        )
        # tag the document root as !core/asdf-1.1.0 like standard asdf
        ydoc = ydoc.replace("---", "--- !core/asdf-1.1.0", 1)
        return ydoc, arrays


class _TaggedMap(dict):
    """A dict that serializes with an explicit YAML tag."""

    def __init__(self, tag, mapping):
        super().__init__(mapping)
        self.yaml_tag = tag


def _make_dumper():
    class Dumper(yaml.SafeDumper):
        pass

    def _rep_tagged(dumper, data):
        return dumper.represent_mapping("!" + data.yaml_tag.split("asdf/")[-1], dict(data))

    Dumper.add_representer(_TaggedMap, _rep_tagged)
    Dumper.add_representer(
        type(None), lambda d, v: d.represent_scalar("tag:yaml.org,2002:null", "null")
    )
    return Dumper


def open(path):  # noqa: A001 - mirror asdf.open
    """Open an ASDF file and return an :class:`AsdfFile` with a resolved tree."""
    with _io.open(path, "rb") as f:
        data = f.read()
    # YAML document runs until the '...' end-of-document marker — which
    # must be ALONE on its line (a tree string/block scalar whose line
    # happens to start with '...' is document content, and a bare
    # substring find would truncate the parse there)
    m = _re.search(rb"\n\.\.\.[ \t\r]*\n", data)
    end = m.start() if m else -1
    if end < 0:
        blk = data.find(BLOCK_MAGIC)
        end = blk if blk >= 0 else len(data)
        ytext = data[:end]
        pos = end
    else:
        ytext = data[: end + 1]
        pos = data.find(BLOCK_MAGIC, end)
        if pos < 0:
            pos = len(data)
    tree = yaml.load(ytext.decode("utf-8", "replace"), Loader=_make_loader())
    if tree is None:
        tree = {}
    tree.pop("asdf_library", None)
    tree.pop("history", None)
    blocks = _read_blocks(data, pos)
    return AsdfFile(_resolve(tree, blocks))
