"""Row-sharded (spatial) calibration of one SCA over a mesh of devices.

The production parallelism is the SCA axis of :mod:`.` (``parallel``):
SCAs are independent, so the focal plane runs them with no traffic
between devices.  This module is the other axis: the rows of ONE frame
are cut into slabs over a mesh, so one exposure's calibration runs on
several devices (fewer SCAs than devices, interactive recalibration).

A mesh is an ordered tuple of torch devices, as in :func:`.sca_mesh`;
entries may repeat (``("cpu",) * 8``, or ``cuda:0`` twice).  Slab ``i``
belongs to entry ``i``.  Torch has no partitioner to insert the
exchanges between slabs, so they are explicit:

- each slab carries :data:`HALO` rows of its neighbours' rows above and
  below (1 for the 3 x 3 saturation grow, which decides the linearity's
  ``attempt`` mask on the IPC inverse's source rows, and 2 for the
  order-2 IPC inverse), trimmed after the IPC stage;
- what spans the rows (the refpix row fit and the medians of the amp33
  block, the channel lines from the frame's edge rows, the WFI18 fit,
  the sky mode and the medfit block medians) is computed once on the
  mesh's first entry from gathered rows and sent back.

The math is the single-SCA core's own: :func:`make_spatial_calibrator`
runs :func:`..pipeline.l1_to_l2.calibrate_rows`, the function that
:func:`..pipeline.l1_to_l2.make_core` runs on the whole frame, on the
slabs.  Every stage is issued from the calling thread, entry after
entry; CUDA launches are asynchronous, so several devices still
overlap, and the kernel wrappers' launch counters stay exact.

Numerics: on the CPU and on one card the slabs give the single core's
outputs (the per-pixel stages see the same values, the gathered
reductions the same vectors); the gate is that of the JAX package's
``tests/test_spatial.py``: integer outputs bit-exact, float maps within
1e-4 relative, ``chisq`` and ``dumo`` within 1e-3.
"""

import numpy as np
import torch

from ..config import resolve_device
from ..io.staging import place
from ..ops import ipc_slab
from ..pipeline import l1_to_l2
from ..utils.rows import split_rows
from . import sca_mesh

#: rows of halo a slab carries where it has a neighbour: the saturation
#: grow's row and the two the order-2 IPC inverse reads
HALO = 1 + ipc_slab.NEUMANN_EXT

#: core outputs shared by every slab rather than split by rows
REPLICATED_OUTPUTS = ("medsky", "skycoefs")


class RowShards(list):
    """A frame's slabs in row order: one dict per mesh entry (the bundle
    of :func:`shard_rows`, or the core's outputs), with the frame rows
    of each in :attr:`rows` (:class:`..utils.rows.Rows`)."""

    def __init__(self, parts, rows):
        super().__init__(parts)
        self.rows = list(rows)


def row_mesh(n_devices=None, devices=None):
    """The 1-D mesh of slabs: an ordered tuple of torch devices, every
    CUDA device by default (the first ``n_devices``; raises without a
    GPU), or the entries of ``devices``, repeats included."""
    return sca_mesh(n_devices, devices)


def row_spec(v, nside, nborder):
    """Which axis of one bundle array holds the frame's rows: -2 for a
    3-D array whose axis 1 has the full ``nside`` or the active ``nside -
    2 * nborder`` rows (a cube, the IPC planes, ``biascorr``), 0 for a
    2-D array with such rows (a frame, the amp33 block), ``None`` for an
    array at metadata scale (weight tables, coefficient vectors,
    scalars), which every slab holds whole.  The classification of the
    JAX package's ``row_spec``."""
    shape = tuple(v.shape) if hasattr(v, "shape") else np.shape(v)
    rows = {nside, nside - 2 * nborder}
    if len(shape) == 3 and shape[1] in rows:
        return -2
    if len(shape) == 2 and shape[0] in rows:
        return 0
    return None


def shard_rows(mesh, arrs, geom):
    """Cut a calibration bundle (``l1_to_l2.prepare_inputs``' ``arr`` or
    ``benchlib.core_bundle``'s; tensors or numpy arrays) into one slab
    per mesh entry, each placed on its entry's device.

    Row-bearing arrays (:func:`row_spec`) are cut at the slab's frame
    rows, :data:`HALO` rows of each neighbour included; active-height
    arrays (``biascorr``, ``dark_slope_ipc``, ``flat_ipc``) at the same
    frame rows' active part.  Arrays at metadata scale are placed whole,
    once per device.  The rows need not divide evenly over the mesh (the
    JAX package commits such an array replicated; here the slabs are
    cut unevenly, :func:`..utils.rows.split_rows`).  Returns a :class:`RowShards`
    to pass to the core of :func:`make_spatial_calibrator`.
    """
    nside, nb, _ = geom
    mesh = tuple(resolve_device(d) for d in mesh)
    rows = split_rows(nside, len(mesh), HALO)
    placed, parts = {}, []
    for dev, r in zip(mesh, rows):
        part = {}
        for k, v in arrs.items():
            axis = row_spec(v, nside, nb)
            if axis is None:
                key = (k, str(dev))
                if key not in placed:
                    placed[key] = place(v, dev)
                part[k] = placed[key]
                continue
            if v.shape[axis] == nside:
                span = slice(r.y0, r.y0 + r.n)
            else:  # active height: the same frame rows' active part
                span = r.active_span(nside, nb)
            part[k] = place(v[span] if axis == 0 else v[:, span], dev)
        parts.append(part)
    return RowShards(parts, rows)


def sca_row_mesh(n_sca, n_row, devices=None):
    """The 2-D mesh (SCA x row): a tuple of ``n_sca`` row meshes of
    ``n_row`` entries, from ``devices`` in order (every CUDA device by
    default, which must be ``n_sca * n_row``; raises without a GPU)."""
    n = n_sca * n_row
    flat = sca_mesh(n if devices is None else None, devices)
    if len(flat) != n:
        raise ValueError(f"a {n_sca} x {n_row} mesh needs {n} entries, got {len(flat)}")
    return tuple(flat[i * n_row : (i + 1) * n_row] for i in range(n_sca))


def shard_batch_rows(mesh, arrays, geom):
    """A stacked bundle (leading SCA axis, as for ``parallel.shard_batch``)
    over a :func:`sca_row_mesh`: lane ``i`` cut into slabs over row mesh
    ``i`` (:func:`shard_rows`).  Returns the list of lanes' shards."""
    n = len(next(iter(arrays.values())))
    if n != len(mesh):
        raise ValueError(f"{n} lanes on a mesh of {len(mesh)} SCA rows")
    return [shard_rows(mesh[i], {k: v[i] for k, v in arrays.items()}, geom)
            for i in range(n)]


def make_spatial_calibrator(plan, cfg, geom, mesh):
    """The L1 -> L2 calibration core over row slabs.

    Returns ``core(parts)``: ``parts`` from :func:`shard_rows` gives the
    frame's outputs as a :class:`RowShards` (each slab's dict on its
    entry's device: its own rows, ``endslice`` its active rows,
    ``medsky`` / ``skycoefs`` the same on every entry); the lanes of
    :func:`shard_batch_rows` give a list of them, lane after lane.
    :func:`gather_rows` assembles a full frame.  The math is
    :func:`..pipeline.l1_to_l2.calibrate_rows`, the single-SCA core's.
    ``mesh`` is the row mesh the parts were cut for (a
    :func:`sca_row_mesh` for lanes).

    Usage::

        mesh = spatial.row_mesh(devices=["cuda:0", "cuda:0"])
        core = spatial.make_spatial_calibrator(plan, cfg, geom, mesh)
        out = spatial.gather_rows(core(spatial.shard_rows(mesh, arr, geom)), "cuda:0")
    """
    def run(shards):
        outs = l1_to_l2.calibrate_rows(list(zip(shards, shards.rows)), plan, cfg, geom)
        return RowShards(outs, [r.trimmed() for r in shards.rows])

    def core(parts):
        if isinstance(parts, RowShards):
            return run(parts)
        return [run(p) for p in parts]

    return core


def gather_rows(out, device):
    """The full-frame output dict on ``device`` from a core's
    :class:`RowShards` (a list of them, from lanes: a list of dicts)."""
    if not isinstance(out, RowShards):
        return [gather_rows(o, device) for o in out]
    device = resolve_device(device)
    full = {}
    for k in out[0]:
        if k in REPLICATED_OUTPUTS:
            full[k] = out[0][k].to(device)
        else:
            full[k] = torch.cat([o[k].to(device) for o in out], dim=-2)
    return full
