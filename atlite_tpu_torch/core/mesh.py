"""Device mesh, sharding rules and the distributed aggregation step
(counterpart of ``atlite_tpu/core/mesh.py``).

The JAX package decomposes the work over a ("t", "x") mesh: time is the
data-parallel axis, x the spatial domain decomposition (y stays whole, so
a block's (y, x) plane flattens to its cells), and XLA inserts the
collectives.  Here the same decomposition is explicit:

- a ``Mesh`` is a (t, x) grid of ``torch.device``s of this process.
  Devices may repeat: eight shards on one card run every sharded code
  path (halos, per-shard bands, partial sums) on that card; several local
  cards exchange halos and partial sums by peer copies.  Only "t" spans
  processes (``core/comm.py``), as in the JAX package, so no collective
  ever runs per step across processes;
- ``put_global``/``shard_fields`` cut an array into the blocks of a
  ``PartitionSpec`` and place each on its device: a ``ShardedTensor``,
  whose ``gather()`` rebuilds the array (this process's part of it);
- elementwise physics runs block by block with no communication; the
  bus aggregation contracts each block's cells with its own columns of
  the matrix and sums the partial series over "x" (the ``psum``).

A mesh holds devices of one type, so a mesh of cards never carries on on
the CPU, and halos and partial sums move between cards only.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import scipy.sparse as sp
import torch

from atlite_tpu_torch.core.device import fp32_matmul

AXES = ("t", "x")


class PartitionSpec(tuple):
    """The mesh axis ("t", "x" or None) that splits each dimension of an
    array, as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        bad = [a for a in axes if a not in (None, *AXES)]
        if bad:
            raise ValueError(f"unknown mesh axes {bad}; a mesh has {AXES}")
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)}"


P = PartitionSpec
NamedSharding = namedtuple("NamedSharding", "mesh spec")


class Mesh:
    """A ("t", "x") grid of the devices of this process.

    ``devices`` is (t_local, x) of ``torch.device``s, which may repeat;
    ``shape`` is the global {"t": ..., "x": ...}.  In a mesh that spans
    processes (``comm.global_mesh``) this process holds the t rows
    [t_offset, t_offset + t_local) of ``shape["t"]``.
    """

    axis_names = AXES

    def __init__(self, devices, t_offset=0, t_size=None, process_index=0, process_count=1):
        rows = [[torch.device(d) for d in row] for row in devices]
        t_local, x = len(rows), len(rows[0]) if rows else 0
        if t_local < 1 or x < 1 or any(len(r) != x for r in rows):
            raise ValueError("a mesh needs a non-empty rectangular (t, x) grid of devices")
        self.devices = np.empty((t_local, x), dtype=object)
        for i, row in enumerate(rows):
            for j, d in enumerate(row):
                self.devices[i, j] = d
        types = {d.type for d in self.devices.ravel()}
        if len(types) != 1 or not types <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh holds CUDA cards or CPU devices, not both: {sorted(types)}")
        t_size = t_local if t_size is None else t_size
        if not 0 <= t_offset <= t_size - t_local:
            raise ValueError(f"rows {t_offset}..{t_offset + t_local} outside t={t_size}")
        self.shape = {"t": t_size, "x": x}
        self.local_shape = {"t": t_local, "x": x}
        self.t_offset = t_offset
        self.process_index, self.process_count = process_index, process_count

    @property
    def device_type(self):
        return self.devices[0, 0].type

    @property
    def size(self):
        return self.shape["t"] * self.shape["x"]

    def positions(self):
        """Local mesh positions (t row, x column), row by row; t rows in
        this process's numbering (0..t_local)."""
        return [(i, j) for i in range(self.local_shape["t"]) for j in range(self.shape["x"])]

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, local t rows {self.t_offset}.."
                f"{self.t_offset + self.local_shape['t']}, {len(set(self.devices.ravel()))} "
                f"distinct {self.device_type} devices)")


def make_mesh(devices=None, t_axis=None):
    """Build a ("t", "x") mesh over the given devices (default: every local
    CUDA card; raises without one).  The time axis gets the larger factor
    of the most balanced factorization n = t * x: 8 devices give (4, 2),
    6 give (3, 2), 1 gives (1, 1).  Devices may repeat, e.g.
    ``[torch.device("cuda", 0)] * 8`` or ``[torch.device("cpu")] * 8``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is available; pass devices= (e.g. "
                               "[torch.device('cpu')] * 8) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if t_axis is None:
        t_axis = next(t for t in range(int(np.sqrt(n)), 0, -1) if n % t == 0)
        t_axis = n // t_axis
    x_axis = n // t_axis
    assert t_axis * x_axis == n, f"cannot factor {n} devices into (t={t_axis}, x)"
    return Mesh([devices[i * x_axis:(i + 1) * x_axis] for i in range(t_axis)])


def field_spec():
    """PartitionSpec for (T, Y, X) field tensors."""
    return P("t", None, "x")


def table_spec():
    """PartitionSpec for per-time (T,) ephemeris tables."""
    return P("t")


def _parts(mesh, spec, shape):
    """Pieces of each dimension: the mesh axis's size where it divides the
    dimension, else 1 (the dimension stays whole on every device)."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the array has dimensions {shape}")
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    parts = []
    for n, axis in zip(shape, spec):
        k = mesh.shape[axis] if axis is not None else 1
        parts.append(k if k > 1 and n % k == 0 else 1)
    return spec, tuple(parts)


class ShardedTensor:
    """One array over a mesh: the block of each local mesh position as a
    tensor on that position's device.

    ``spec`` names the mesh axis of each dimension and ``parts`` the number
    of pieces it is cut into (1: whole on every device).  Positions that
    hold the same piece on the same device share one tensor.  ``shape`` is
    the global shape where the blocks were cut from an array (None where
    they were computed block by block); ``gather()`` rebuilds this
    process's part of the array.
    """

    def __init__(self, mesh, spec, parts, blocks, shape=None):
        self.mesh, self.spec, self.parts = mesh, tuple(spec), tuple(parts)
        self.blocks = blocks
        self.shape = None if shape is None else tuple(shape)

    def piece(self, i, j):
        """The piece index of each dimension at local position (i, j)."""
        at = {"t": i + self.mesh.t_offset, "x": j}
        return tuple(at[a] if k > 1 else 0 for a, k in zip(self.spec, self.parts))

    def __getitem__(self, ij):
        return self.blocks[ij]

    @property
    def dtype(self):
        return self.blocks[0, 0].dtype

    def distinct(self):
        """[(position, block)] holding each local piece once: the first
        position, in mesh order, that holds it."""
        seen, out = set(), []
        for ij in self.mesh.positions():
            p = self.piece(*ij)
            if p not in seen:
                seen.add(p)
                out.append((ij, self.blocks[ij]))
        return out

    def gather(self, device=None):
        """This process's part of the array as one tensor on ``device``
        (default: the first block's): the whole array on a single-process
        mesh, this process's t rows on a mesh that spans processes."""
        pieces = self.distinct()
        device = torch.device(device) if device is not None else pieces[0][1].device
        # each dimension's local pieces: their sizes, then their offsets
        sizes = [{} for _ in range(pieces[0][1].ndim)]
        for ij, b in pieces:
            for d, p in enumerate(self.piece(*ij)):
                sizes[d][p] = b.shape[d]
        offsets = [dict(zip(sorted(sz), np.cumsum([0] + [sz[k] for k in sorted(sz)])))
                   for sz in sizes]
        out = torch.empty([sum(sz.values()) for sz in sizes], dtype=self.dtype, device=device)
        for ij, b in pieces:
            sl = tuple(slice(int(offsets[d][p]), int(offsets[d][p]) + b.shape[d])
                       for d, p in enumerate(self.piece(*ij)))
            out[sl] = _to(b, device)
        return out

    def __repr__(self):
        return (f"ShardedTensor(shape={self.shape}, spec={self.spec}, parts={self.parts}, "
                f"{self.dtype}, {self.mesh!r})")


def _to(t, device):
    """``t`` on ``device``: a copy to a card is non-blocking (ordered on
    the streams), a copy to the host waits for its data."""
    return t.to(device, non_blocking=device.type == "cuda")


def _as_block(a, device):
    """A piece of a numpy array or tensor as a contiguous tensor on
    ``device`` (numpy pieces are copied, so no tensor aliases a read-only
    memory map)."""
    if isinstance(a, torch.Tensor):
        return _to(a, device).contiguous()
    return _to(torch.from_numpy(np.array(a)), device)


def place(mesh, spec, shape, read):
    """A ShardedTensor of a global array of ``shape``: ``read(slices)``
    returns the piece at those slices (numpy or a tensor), called once a
    distinct piece of this process; the piece goes to every local device
    that holds it."""
    spec, parts = _parts(mesh, spec, shape)
    bounds = [np.arange(k + 1) * n // k for n, k in zip(shape, parts)]
    blocks = np.empty((mesh.local_shape["t"], mesh.shape["x"]), dtype=object)
    st = ShardedTensor(mesh, spec, parts, blocks, shape)
    host, placed = {}, {}
    for ij in mesh.positions():
        p = st.piece(*ij)
        dev = mesh.devices[ij]
        if (p, dev) not in placed:
            if p not in host:
                host[p] = read(tuple(slice(int(b[k]), int(b[k + 1])) for b, k in zip(bounds, p)))
            placed[(p, dev)] = _as_block(host[p], dev)
        blocks[ij] = placed[(p, dev)]
    return st


def put_global(arr, sharding):
    """Place an array (numpy or a tensor) on a mesh as a ShardedTensor:
    ``sharding`` is a ``NamedSharding(mesh, spec)``.  On a mesh that spans
    processes each process places only its own t rows."""
    mesh, spec = sharding
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    return place(mesh, spec, tuple(arr.shape), lambda sl: arr[sl])


def shard_fields(mesh, fields, tables=None):
    """Place a dict of arrays onto the mesh: (T, Y, X) fields on the
    ("t", None, "x") decomposition, (Y, X) statics on (None, "x"), 1-D
    tables on ("t"); an axis that does not divide the mesh stays whole.
    Returns {name: ShardedTensor} (and the tables' dict with ``tables``)."""

    def pick(v):
        nd = np.ndim(v)
        if nd == 3:
            return field_spec()
        if nd == 2:
            return P(None, "x")
        return table_spec()

    out = {k: put_global(v, NamedSharding(mesh, pick(v))) for k, v in fields.items()}
    if tables is None:
        return out
    tabs = {k: put_global(v, NamedSharding(mesh, table_spec())) for k, v in tables.items()}
    return out, tabs


def halo_exchange(block, halo, axis_name="x"):
    """Exchange ``halo`` columns of the last dimension with the ring
    neighbours along a mesh axis.

    ``block`` is a ShardedTensor whose last dimension is cut along
    ``axis_name``; returns a ShardedTensor of blocks (..., X_local +
    2 * halo): the left neighbour's last ``halo`` columns, the block, the
    right neighbour's first ``halo`` columns, copied device to device
    (``non_blocking``: a peer copy between cards).  At the domain's
    boundary the edge column is repeated, not wrapped around.  This is the
    distributed counterpart of the serial ``pad_extent``: stencils
    (regrid) read past their block's edge.
    """
    if halo == 0:
        return block  # block[..., -0:] would select the WHOLE block
    mesh = block.mesh
    if block.spec[-1] != axis_name or block.parts[-1] != mesh.shape[axis_name]:
        raise ValueError(f"the last dimension must be cut along {axis_name!r} into "
                         f"{mesh.shape[axis_name]} pieces, not {block.spec}/{block.parts}")
    if axis_name == "t" and mesh.process_count > 1:
        raise ValueError("a halo along 't' would cross processes; 't' carries no halo")
    n = mesh.local_shape[axis_name]
    out = np.empty_like(block.blocks)
    for i, j in mesh.positions():
        b = block.blocks[i, j]
        k = j if axis_name == "x" else i
        at = (lambda m: (i, m)) if axis_name == "x" else (lambda m: (m, j))
        if k > 0:
            left = _to(block.blocks[at(k - 1)][..., -halo:], b.device)
        else:
            left = b[..., :1].expand(*b.shape[:-1], halo)
        if k < n - 1:
            right = _to(block.blocks[at(k + 1)][..., :halo], b.device)
        else:
            right = b[..., -1:].expand(*b.shape[:-1], halo)
        out[i, j] = torch.cat([left, b, right], dim=-1)
    return ShardedTensor(mesh, block.spec, block.parts, out)


def map_shards(fn, *args):
    """``fn`` applied block by block: each argument is a ShardedTensor or a
    dict of them, all cut alike; ``fn`` gets each argument's blocks at one
    position (a dict of blocks for a dict) and returns that position's
    block, once a distinct piece.  Returns a ShardedTensor cut as the first
    array."""
    flat = [a for arg in args for a in (arg.values() if isinstance(arg, dict) else [arg])]
    like = flat[0]
    if any((a.spec, a.parts) != (like.spec, like.parts) for a in flat):
        raise ValueError("map_shards takes arrays cut alike")

    def at(arg, ij):
        return {k: v[ij] for k, v in arg.items()} if isinstance(arg, dict) else arg[ij]

    out = {like.piece(*ij): fn(*(at(arg, ij) for arg in args)) for ij, _ in like.distinct()}
    return _spread(like, out)


def _as_field(mesh, field):
    """A (T, Y, X) field as a ShardedTensor on the field decomposition."""
    if isinstance(field, ShardedTensor):
        return field
    return put_global(field, NamedSharding(mesh, field_spec()))


class _PerDevice:
    """Tensors made once per (key, device, dtype)."""

    def __init__(self, make):
        self.make, self.cache = make, {}

    def __call__(self, key, device, dtype):
        k = (key, device, dtype)
        if k not in self.cache:
            self.cache[k] = self.make(key, device, dtype)
        return self.cache[k]


def _spread(like, by_piece, shape=None):
    """A ShardedTensor with the spec and pieces of ``like``, whose blocks are
    ``by_piece[piece]``, copied once to each other device that holds it."""
    blocks = np.empty_like(like.blocks)
    copies = {}
    for ij in like.mesh.positions():
        src, dev = by_piece[like.piece(*ij)], like.mesh.devices[ij]
        if src.device != dev and (id(src), dev) not in copies:
            copies[(id(src), dev)] = _to(src, dev)
        blocks[ij] = src if src.device == dev else copies[(id(src), dev)]
    return ShardedTensor(like.mesh, like.spec, like.parts, blocks, shape)


def _sum_over_x(mesh, parts, t_pieces):
    """{(i, j): (T_l, B) partial}, in mesh order, -> ShardedTensor ("t",
    None) of the sums over each t row's x pieces (the ``psum``): summed in
    x order on the row's first device, then held on every device of the
    row.  ``t_pieces``: the field's pieces along t."""
    like = ShardedTensor(mesh, P("t", None), (t_pieces, 1),
                         np.empty((mesh.local_shape["t"], mesh.shape["x"]), dtype=object))
    sums = {}
    for ij, p in parts.items():
        key = like.piece(*ij)
        sums[key] = p if key not in sums else sums[key] + _to(p, sums[key].device)
    return _spread(like, sums)


def sharded_regrid_bilinear(mesh, src_x, src_y, dst_x, dst_y, halo=None):
    """Build a (T, Y, X) -> (T, DY, DX) bilinear regrid over the ("t", "x")
    mesh with x domain decomposition and halo exchange.

    src/dst grids must be uniform and ascending; X and DX must divide the
    mesh's x axis.  The y interpolation stays local (y whole); the x
    interpolation reads up to ``halo`` columns past the block's edge,
    brought by :func:`halo_exchange`.  Both are separable matrix
    contractions: a (DY, Y) matrix for y and, for each x block, a
    (dx_local, x_local + 2 * halo) matrix, in the field's dtype with TF32
    off.  Returns ``regrid(field)``: a ShardedTensor (or an array, placed
    first) in, a ShardedTensor out.
    """
    nx_shards = mesh.shape["x"]
    X, DX = len(src_x), len(dst_x)
    assert X % nx_shards == 0 and DX % nx_shards == 0
    x_local = X // nx_shards
    dx_local = DX // nx_shards

    # fractional source index of every dst column/row (edge-clamped like
    # the serial regrid's mode='edge' padding)
    fx = np.interp(np.asarray(dst_x), np.asarray(src_x), np.arange(X))
    fy = np.interp(np.asarray(dst_y), np.asarray(src_y), np.arange(len(src_y)))
    # the halo each shard needs: how far ITS dst columns reach into
    # src-index space, not the spacing ratio alone (a dst grid offset from
    # the src extent needs columns far outside the local shard)
    needed = 0
    for i in range(nx_shards):
        fi = fx[i * dx_local:(i + 1) * dx_local]
        if fi.size == 0:
            continue
        needed = max(
            needed,
            int(np.ceil(i * x_local - np.floor(fi.min()))),
            int(np.ceil(fi.max() + 1 - (i + 1) * x_local)),
        )
    needed = max(needed, 0)
    if halo is None:
        halo = needed + 1
    elif halo < needed:
        raise ValueError(
            f"halo={halo} too small: dst columns reach {needed} src "
            "columns past their shard")
    if halo > x_local:
        raise ValueError(
            f"required halo {halo} exceeds the local shard width "
            f"{x_local}: the dst grid is too offset from the src domain "
            "decomposition — regrid unsharded or use fewer x shards")

    Ysrc, DY = len(src_y), len(dst_y)
    y0 = np.clip(np.floor(fy).astype(np.int64), 0, Ysrc - 2)
    wy = np.clip(fy - y0, 0.0, 1.0)
    My = np.zeros((DY, Ysrc))
    My[np.arange(DY), y0] = 1.0 - wy
    My[np.arange(DY), y0 + 1] += wy

    wpad = x_local + 2 * halo
    Mx = np.zeros((nx_shards, dx_local, wpad))
    for i in range(nx_shards):
        rel = fx[i * dx_local:(i + 1) * dx_local] - i * x_local + halo
        x0 = np.clip(np.floor(rel).astype(np.int64), 0, wpad - 2)
        wx = np.clip(rel - x0, 0.0, 1.0)
        Mx[i, np.arange(dx_local), x0] = 1.0 - wx
        Mx[i, np.arange(dx_local), x0 + 1] += wx

    my = _PerDevice(lambda _, dev, dt: torch.as_tensor(My, dtype=dt, device=dev))
    mx = _PerDevice(lambda j, dev, dt: torch.as_tensor(Mx[j], dtype=dt, device=dev))

    def regrid(field):
        field = _as_field(mesh, field)
        if field.parts[-1] != nx_shards:
            raise ValueError(f"the field's x must be cut into {nx_shards} pieces")
        padded = halo_exchange(field, halo, "x")  # (t, Y, x_local + 2h)
        out = {}
        with fp32_matmul():
            for (i, j), b in padded.distinct():
                gy = torch.einsum("dy,tyx->tdx", my(None, b.device, b.dtype), b)
                out[padded.piece(i, j)] = torch.einsum("ox,tdx->tdo",
                                                       mx(j, b.device, b.dtype), gy)
        T = field.shape[0] if field.shape else None
        return _spread(padded, out, None if T is None else (T, DY, DX))

    return regrid


def _shard_columns(Y, X, nxs, s):
    """Flat (y-major) cell indices of x block ``s`` of a (Y, X) grid."""
    xloc = X // nxs
    return (np.arange(Y)[:, None] * X + s * xloc + np.arange(xloc)[None, :]).ravel()


def sharded_aggregate_banded(mesh, matrix, Y, X, block_b=128, align=256):
    """Distributed large-matrix bus aggregation: (T, Y, X) -> (T, B).

    The banded formulation (``ops/bsr_spmm.to_banded``: rows sorted by
    column range, dense row-block bands, whole-tile gather, batched
    product) composed with the mesh: the matrix's columns are split by x
    block, each block gets its own bands over its cells (padded to one
    band width, so every block runs the same shapes), and the blocks'
    partial series are summed over "x".  Time stays split end to end.

    NaN rule as the single-device banded path: a NaN cell poisons exactly
    the buses whose rows touch it (an indicator product against the band
    structure, in each block; NaN then survives the sum).  The bands are
    staged in the field's dtype (float32 or float64), once a device.
    Returns ``agg(field)`` -> ShardedTensor ("t", None) of (T, B).
    """
    from atlite_tpu_torch.ops.bsr_spmm import banded_spmm, banded_width, stage_banded, to_banded

    nxs = mesh.shape["x"]
    assert X % nxs == 0, f"X={X} must divide the mesh x axis ({nxs})"
    if matrix.shape[1] != Y * X:
        raise ValueError(
            f"matrix has {matrix.shape[1]} columns but the grid has "
            f"{Y}*{X}={Y * X} cells — a mismatched matrix would silently "
            "drop columns")
    csc = sp.csc_matrix(matrix)
    shards = [csc[:, _shard_columns(Y, X, nxs, s)] for s in range(nxs)]
    # one band width for every block, from the cheap probe
    W = max(banded_width(m, block_b=block_b, align=align)[1] for m in shards)
    W = max(-(-W // align) * align, align)
    banded = [to_banded(m, block_b=block_b, align=align, force_w=W) for m in shards]
    staged = _PerDevice(lambda j, dev, dt: stage_banded(banded[j], dt, dev))

    def agg(field):
        field = _as_field(mesh, field)
        if field.parts[-1] != nxs:
            raise ValueError(f"the field's x must be cut into {nxs} pieces")
        parts = {}
        for (i, j), b in field.distinct():
            flat = b.reshape(b.shape[0], -1)  # local y-major (y, x_local) cells
            parts[(i, j)] = banded_spmm(banded[j], flat, staged(j, b.device, b.dtype))
        return _sum_over_x(mesh, parts, field.parts[0])

    agg.banded = banded
    return agg


def sharded_aggregate(mesh, matrix_dense, shape=None):
    """Return a (T, Y, X) -> (T, B) bus aggregation for a dense matrix.

    ``matrix_dense`` is (B, Y*X) row-major over (y, x) or (B, Y, X) (or
    (B, Y*X) with ``shape=(Y, X)``).  Each x block contracts its cells with
    its own columns of the matrix, and the partial series are summed over
    "x".  NOTE, as in the JAX package: this dense contraction spreads a
    NaN cell to every bus (NaN * 0-weight); the single-device aggregation
    and ``sharded_aggregate_banded`` keep the sparse NaN rule (only the
    touching buses) — sanitize NaNs first if that distinction matters.
    """
    matrix_dense = np.asarray(matrix_dense)
    if matrix_dense.ndim == 2 and shape is not None:
        matrix_dense = matrix_dense.reshape(matrix_dense.shape[0], *shape)

    def columns(key, device, dtype):
        j, nxs, Y, X = key
        if matrix_dense.ndim == 3:
            m = matrix_dense[:, :, j * (X // nxs):(j + 1) * (X // nxs)]
            m = m.reshape(m.shape[0], -1)
        else:
            m = matrix_dense[:, _shard_columns(Y, X, nxs, j)]
        return torch.as_tensor(np.ascontiguousarray(m), dtype=dtype, device=device)

    cols = _PerDevice(columns)

    def agg(field):
        field = _as_field(mesh, field)
        nxs = field.parts[-1]
        parts = {}
        with fp32_matmul():
            for (i, j), b in field.distinct():
                Y, X = b.shape[1], b.shape[2] * nxs
                m = cols((j, nxs, Y, X), b.device, b.dtype)
                parts[(i, j)] = b.reshape(b.shape[0], -1) @ m.T
        return _sum_over_x(mesh, parts, field.parts[0])

    return agg
