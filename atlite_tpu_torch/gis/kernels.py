"""Device path of the availability matrix (counterpart of
``atlite_tpu/gis/kernels.py``), plain PyTorch on the cutout's device.

Instead of atlite's per-shape loop of GDAL rasterize + warp (a
multiprocessing Pool, its gis.py:661-756), the whole availability matrix
is a few batched device operations on one shared fine lattice, streamed
over blocks of fine rows:

1. rasterize all shapes at once: even-odd crossings at pixel centres,
2. AND with the exclusion mask of the same lattice (built on the host by
   ``gis.exclusion.build_exclusion_mask``, uploaded as packed bits and
   cached on the excluder),
3. downsample onto the cutout grid: in the excluder's CRS, two
   overlap-matrix products, ``Wy @ mask @ Wx.T``, with full float32
   products (TF32 off); across CRSs, every pixel centre mapped to its
   cell by the closed-form CRS math on the device and the available
   pixels counted per cell (integer counts, exact).

Rasterization keeps the JAX package's comparisons exactly (the abscissa
``x1 + (yb - y1) / denom * (x2 - x1)`` where an edge crosses a row, and a
pixel inside when an odd number of them lie strictly right of its centre)
but not its formulation: the crossings depend on the row alone, so each
(shape, row) gets its E abscissae once, each abscissa the count of pixel
centres left of it (``searchsorted`` on the ascending centres), and the
parity of every pixel is a prefix sum along the row.  Across CRSs even
that per-pixel mask is skipped: a row's cell ids change in runs, and each
run's count follows from the sorted crossings and the row's prefix count
of available pixels.  The work is O(S·rows·nx) in the excluder's CRS and
O(S·rows·(E + runs)) across CRSs, where the JAX package's broadcast is
O(S·E·rows·nx).

The fine lattice is the res-snapped cover of the cutout extent, so results
match the host path on the shared lattice (the snapping rule of
``padded_transform_and_shape``).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from atlite_tpu_torch.aggregate import fp32_matmul
from atlite_tpu_torch.gis import geometry as G
from atlite_tpu_torch.profiling import span

logger = logging.getLogger(__name__)

# elements of the (shapes, rows, edges) crossing table of one row tile
_TILE_ELEMS = 1 << 24
# a cross-CRS block holds max_device_pixels / PIXEL_BYTES fine pixels: each
# carries several per-pixel arrays (its cell id, run boundary, prefix count,
# the CRS math's float32 temporaries) where a pixel-shape of the same-CRS
# path carries one boolean
PIXEL_BYTES = 8


def shapes_to_edges(geoms, max_edges=None):
    """Pack polygon edges into padded (S, E, 4) [x1 y1 x2 y2] + (S, E) mask.

    Holes are included as additional edges — even-odd crossing counting
    handles them without distinction.  MultiPolygons concatenate their
    parts (even-odd stays correct because parts are disjoint).
    """
    all_edges = []
    for geom in geoms:
        geom = G.parse_geometry(geom)
        polys = geom.polygons if isinstance(geom, G.MultiPolygon) else [geom]
        e = []
        for p in polys:
            for ring in (p.shell, *p.holes):
                nxt = np.roll(ring, -1, axis=0)
                e.append(np.column_stack([ring, nxt]))
        all_edges.append(np.concatenate(e, axis=0))
    E = max(len(e) for e in all_edges) if max_edges is None else max_edges
    S = len(all_edges)
    edges = np.zeros((S, E, 4))
    mask = np.zeros((S, E), dtype=bool)
    for i, e in enumerate(all_edges):
        edges[i, : len(e)] = e
        mask[i, : len(e)] = True
    return edges, mask


def _crossings(edges, edge_mask, yb):
    """(S, rows, E) abscissae where each edge crosses the line y = yb of
    each row, -inf where it does not (the JAX package's ``cond``, its
    guarded division and its order of operations)."""
    x1, y1, x2, y2 = (edges[..., i][:, None, :] for i in range(4))
    yb = yb[None, :, None]
    cond = (y1 > yb) != (y2 > yb)
    # y2 == y1 edges never satisfy cond; guard the division anyway
    denom = torch.where(y2 == y1, 1.0, y2 - y1)
    xint = x1 + (yb - y1) / denom * (x2 - x1)
    return torch.where(cond & edge_mask[:, None, :], xint, -torch.inf)


def _rasterize(edges, edge_mask, px, py, row_tile):
    """(S, ny, nx) bool of pixel centres inside each shape, for ascending
    ``px``: a pixel is inside when an odd number of its row's crossings
    lie strictly right of its centre.  Crossing k lies right of the first
    j_k = #(px < x_k) centres, so the count at column c is E minus the
    number of k with j_k <= c: its parity is a prefix sum along the row of
    flips at the j_k (and at column 0 for an odd E), summed in uint8 (it
    wraps, its parity holds) in place."""
    S, E = edge_mask.shape
    ny, nx = py.shape[0], px.shape[0]
    tile = min(max(ny, 1), max(row_tile, _TILE_ELEMS // max(S * E, 1)))
    out = None if tile >= ny else torch.empty((S, ny, nx), dtype=torch.bool, device=px.device)
    for r0 in range(0, ny, tile):
        yb = py[r0:r0 + tile]
        j = torch.searchsorted(px, _crossings(edges, edge_mask, yb))
        keep = (j < nx).to(torch.uint8)  # j == nx: right of every centre
        flips = torch.zeros((S, yb.shape[0], nx), dtype=torch.uint8, device=px.device)
        if E % 2:
            flips[..., 0] = 1
        flips.scatter_add_(2, j.clamp_(max=nx - 1), keep)
        inside = flips.cumsum_(2).bitwise_and_(1).view(torch.bool)
        if out is None:
            return inside
        out[:, r0:r0 + tile] = inside
    return out


def rasterize_shapes(edges, edge_mask, px, py, row_tile=64):
    """(S, ny, nx) bool: pixel-center-in-shape, batched over shapes.

    edges: (S, E, 4); px: (nx,), py: (ny,) pixel-center coordinates, all
    tensors on one device.  Rows go in tiles of at least ``row_tile``
    rows, as many as keep the (S, tile, E) crossing table within
    ``_TILE_ELEMS`` elements; the (S, tile, nx) flips take one byte a
    pixel-shape.  ``px`` in any order (the device path's is ascending)."""
    if px.shape[0] > 1 and not bool((px[1:] >= px[:-1]).all()):
        order = torch.argsort(px)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        return _rasterize(edges, edge_mask, px[order], py, row_tile)[..., inv]
    return _rasterize(edges, edge_mask, px, py, row_tile)


def average_downsample(masks, Wy, Wx):
    """(S, NY, NX) average share from (S, ny, nx) bool masks via the
    separable overlap matrices: two float32 products a shape batch."""
    m = masks.to(Wy.dtype)
    with fp32_matmul():
        num = Wy @ (m @ Wx.T)
    den = (Wy.sum(dim=1)[:, None] * Wx.sum(dim=1)[None, :])[None]
    return num / den


def _block_masks(edges, emask, px, py_blk, excl_blk, row_tile=64):
    """Rasterize all shapes on a fine-row block and apply the exclusion
    mask: the (S, rows, nx) bool masks."""
    return _rasterize(edges, emask, px, py_blk, row_tile) & ~excl_blk


def _block_partial(edges, emask, px, py_blk, excl_blk, Wy_blk, Wx, row_tile=64):
    """Downsampled partial sums of one fine-row block: rasterize all shapes
    on the block, AND with the exclusion mask, contract onto the cutout
    lattice.  Full float32 products: the Wy/Wx overlap weights are
    fractional, and TF32 would break the host path's equivalence."""
    fine = _block_masks(edges, emask, px, py_blk, excl_blk, row_tile).to(torch.float32)
    with fp32_matmul():
        return Wy_blk @ (fine @ Wx.T)


def _cell_ids(px, py_blk, inv_affine, ri0, *, src_crs, dst_crs, NX, NY, bins):
    """(rows, nx) int64 local cell id of every pixel centre of a block,
    mapped by the closed-form CRS math on the device (float32), the
    overflow bin ``bins - 1`` outside the block's window of cutout rows
    from ``ri0``; and ``dropped``, the count of pixels inside the cutout
    but outside the window (0-dim tensor)."""
    from atlite_tpu_torch.gis.crs import transform_points_xp

    lon, lat = torch.broadcast_tensors(*transform_points_xp(
        px[None, :], py_blk[:, None], src_crs, dst_crs, torch))
    a, b, c, d, e, f = inv_affine
    ci = torch.floor(a * lon + b * lat + c).to(torch.int32)
    ri = torch.floor(d * lon + e * lat + f).to(torch.int32)
    in_cut = (ci >= 0) & (ci < NX) & (ri >= 0) & (ri < NY)
    ok = in_cut & (ri >= ri0) & (ri < ri0 + (bins - 1) // NX)
    # pixels inside the cutout but outside the sampled row window would be
    # silently lost — count them so the caller can redo the block exactly
    dropped = (in_cut & ~ok).sum()
    return torch.where(ok, (ri - ri0) * NX + ci, bins - 1).to(torch.int64), dropped


def _block_cells_crosscrs(edges, emask, px, py_blk, excl_blk, inv_affine, ri0, *,
                          src_crs, dst_crs, NX, NY, bins):
    """Cross-CRS fine-block contraction, on the device: for each shape,
    the count of its available pixels (inside and not excluded) in each
    cell of the block's window (``bins - 1`` cells: the few cutout rows
    the block can touch x NX, +1 overflow bin for pixels outside; ``ri0``
    is the window's first cutout row), and the count of all pixels a
    cell.

    No per-shape pixel mask is made.  Along a row the cell id changes in
    runs (a cell is tens of pixels wide), and a shape's inside pixels are
    the spans between its sorted crossings that an odd count lies right
    of; with A, the row's prefix count of available pixels, the
    available inside pixels left of any column are the whole spans'
    sums plus the part of the span it falls in.  Each run's count is the
    difference of that at its two ends: O(S·rows·(E + runs)) work where
    the pixel mask is O(S·rows·nx), exact integers.  Finding the runs
    waits for the device once a block.

    Returns (num (S, bins), cnt (bins,), dropped) as int64 counts.
    """
    S, E = emask.shape
    rows, nx = excl_blk.shape
    dev = px.device
    lid, dropped = _cell_ids(px, py_blk, inv_affine, ri0, src_crs=src_crs, dst_crs=dst_crs,
                             NX=NX, NY=NY, bins=bins)
    # run boundaries (row r, column t): each row's 0 and nx, and every
    # column where the cell id changes; row-major order
    change = torch.ones((rows, nx + 1), dtype=torch.bool, device=dev)
    change[:, 1:nx] = lid[:, 1:] != lid[:, :-1]
    r, t = torch.nonzero(change, as_tuple=True)
    # A[r, c]: available pixels of row r left of column c
    A = torch.zeros((rows, nx + 1), dtype=torch.int64, device=dev)
    A[:, 1:] = torch.cumsum(~excl_blk, dim=1)
    # each (shape, row)'s crossings as the count j of centres left of
    # them, ascending: span k = [j_(k-1), j_k) (j_(-1) = 0, j_E = nx)
    # holds k crossings at or left of its columns, so it is inside when
    # E - k is odd
    j = torch.searchsorted(px, _crossings(edges, emask, py_blk)).sort(dim=2).values
    odd = (E - torch.arange(E + 1, device=dev)) & 1
    Aj = torch.gather(A.expand(S, rows, nx + 1), 2, j)
    A_left = torch.nn.functional.pad(Aj, (1, 0))  # A at each span's left end
    W = torch.nn.functional.pad(torch.cumsum(odd[:E] * (Aj - A_left[..., :E]), dim=2), (1, 0))
    # k at each boundary: the crossings of its row at or left of it, by
    # one search of the row-major keys of all crossings
    key = r * (nx + 1) + t
    jkey = (j + (torch.arange(rows, device=dev) * (nx + 1))[None, :, None]).reshape(S, -1)
    k = torch.searchsorted(jkey, key.expand(S, -1).contiguous(), right=True) - r * E
    at = r * (E + 1) + k
    inside_left = W.reshape(S, -1).gather(1, at) + odd[k] * (
        A.reshape(-1)[key] - A_left.reshape(S, -1).gather(1, at))
    # each run: the difference at its two ends; pairs across rows go to
    # the overflow bin with nothing
    same = r[1:] == r[:-1]
    run_lid = torch.where(same, lid[r[:-1], t[:-1].clamp(max=nx - 1)], bins - 1)
    num = torch.zeros((S, bins), dtype=torch.int64, device=dev)
    num.index_add_(1, run_lid, torch.where(same, inside_left[:, 1:] - inside_left[:, :-1], 0))
    cnt = torch.zeros(bins, dtype=torch.int64, device=dev)
    cnt.index_add_(0, run_lid, torch.where(same, t[1:] - t[:-1], 0))
    return num, cnt, dropped


def _unpack_mask_device(packed, n):
    """np.packbits mirror on the device: (bytes,) uint8 -> (n,) bool by
    elementwise shifts."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n].bool()


class _Uploader:
    """Packed mask blocks onto the device: on a card through two pinned
    staging buffers in turn, each copy non-blocking and the buffer reused
    only once its copy has ended; on the CPU the array itself."""

    def __init__(self, device):
        self.device = device
        self.bufs = [None, None]
        self.done = [None, None]
        self.turn = 0

    def __call__(self, packed):
        if self.device.type != "cuda":
            return torch.from_numpy(packed)
        i, self.turn = self.turn, 1 - self.turn
        if self.done[i] is not None:
            self.done[i].synchronize()
        if self.bufs[i] is None or self.bufs[i].numel() < packed.size:
            self.bufs[i] = torch.empty(packed.size, dtype=torch.uint8, pin_memory=True)
        staged = self.bufs[i][:packed.size]
        staged.numpy()[:] = packed
        out = staged.to(self.device, non_blocking=True)
        self.done[i] = torch.cuda.Event()
        self.done[i].record()
        return out


def _excl_from_parts(parts):
    """Block accessor over a cached {(b0, b1): device_block} mask: direct
    hit for a matching block, lazy one-time concatenation + slice for a
    mismatched block structure (e.g. a different shape count changed
    row_block)."""
    state = {}

    def get_excl(b0, b1):
        blk = parts.get((b0, b1))
        if blk is not None:
            return blk
        if "full" not in state:
            ordered = [parts[k] for k in sorted(parts)]
            state["full"] = torch.cat(ordered, dim=0) if len(ordered) > 1 else ordered[0]
        return state["full"][b0:b1]

    return get_excl


class _ColdMask:
    """A cold call's fine mask, block by block: each block built by
    ``build(b0, b1)`` (packed bits) on one worker thread, the next one
    queued while the device works on this one, uploaded and unpacked on
    ``device``.  Blocks may be asked for in any order; each part is kept
    under its own bounds, and ``finish`` caches them on the excluder once
    every block was made (one copy of the mask on the device)."""

    def __init__(self, blocks, build, nx, device, excluder, cache_key):
        self.blocks, self.build, self.nx = blocks, build, nx
        self.excluder, self.cache_key = excluder, cache_key
        self.worker = ThreadPoolExecutor(max_workers=1)
        self.upload = _Uploader(device)
        self.futs = {}
        self.parts = {}
        if blocks:
            self.futs[blocks[0]] = self.worker.submit(build, *blocks[0])

    def get(self, b0, b1):
        i = self.blocks.index((b0, b1))
        if (b0, b1) not in self.futs:
            self.futs[(b0, b1)] = self.worker.submit(self.build, b0, b1)
        packed = self.futs[(b0, b1)].result()
        if i + 1 < len(self.blocks) and self.blocks[i + 1] not in self.futs:
            self.futs[self.blocks[i + 1]] = self.worker.submit(self.build, *self.blocks[i + 1])
        blk = _unpack_mask_device(self.upload(packed), (b1 - b0) * self.nx)
        self.parts[(b0, b1)] = blk = blk.reshape(b1 - b0, self.nx)
        return blk

    def finish(self):
        """Idempotent; called in a finally, so an exception mid-loop never
        leaks the worker thread or its queued builds."""
        self.worker.shutdown(wait=True, cancel_futures=True)
        if len(self.parts) == len(self.blocks):
            self.excluder._fine_mask_cache = (self.cache_key, dict(self.parts))


class _BlockExcluder:
    """Read-only per-block view of an ExclusionContainer for the pipelined
    cold mask build: rasters carry allow_no_overlap=True (the overlap
    contract was already validated against the FULL lattice window — a
    raster merely missing one row block must not raise) while the layer
    dict copies share the cached native code masks."""

    def __init__(self, exc):
        self.rasters = [dict(d, allow_no_overlap=True) for d in exc.rasters]
        self.geometries = exc.geometries
        self.res = exc.res
        self.crs = exc.crs
        self.all_open = True


def availability_matrix_device(cutout, shapes_geoms, excluder,
                               shapes_crs=4326, row_tile=64,
                               max_device_pixels=64_000_000, mesh=None):
    """Full availability matrix on the cutout's device (a CUDA card, or the
    CPU); equivalent to the host path on the shared res-snapped lattice.
    Returns (S, Y, X) numpy (ascending y, like compute_availabilitymatrix).

    Streams over fine-raster row blocks (bounded by ``max_device_pixels``
    of S×rows×nx boolean work at a time in the excluder's CRS, and by
    ``max_device_pixels / PIXEL_BYTES`` pixels across CRSs, where no
    per-shape mask is made), accumulating the downsampled partial sums on
    the device and reading them back once, after every block was
    dispatched — scales to country-size 100 m lattices.

    ``mesh`` (a ``core.mesh.Mesh``): the shapes axis is padded with empty
    shapes to a multiple of the mesh's devices (this process's) and split
    over them, one group of shapes a device in mesh order (the multi-device
    counterpart of atlite's Pool over shapes); each device runs the same
    per-block path on its group, in turn; the groups are joined and the
    padding trimmed.  The excluder caches the exclusion mask of one device
    (the last), so positions on one card share it and a second card
    builds its own.
    """
    from atlite_tpu_torch.core.mesh import Mesh
    from atlite_tpu_torch.gis.exclusion import _as_geometry_list

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a core.mesh.Mesh, not {type(mesh).__name__}")
    if not excluder.all_open:
        excluder.open_files()
    if any(d["buffer"] for d in excluder.rasters):
        # atlite crops each raster to the QUERY shape before dilation
        # (projected_mask crop=True, gis.py:197-230), so buffer sources
        # outside the shape never fire — per-shape semantics the shared
        # (shape-independent, cached) device mask cannot express.  The
        # auto backend catches this and uses the host path.
        raise NotImplementedError(
            "buffered raster exclusion layers require per-shape crop "
            "semantics (host path)")
    # the query shapes, rasterized in batches on the device (float32, as
    # the JAX package on its chip)
    geoms = _as_geometry_list(shapes_geoms, shapes_crs, excluder.crs)
    edges, emask = shapes_to_edges(geoms)
    if mesh is None:
        return _availability_on(cutout, cutout.device, edges, emask, excluder, row_tile,
                                max_device_pixels)
    devices = list(mesh.devices.ravel())
    S = edges.shape[0]
    pad = (-S) % len(devices)
    # padded shapes have no edges: they rasterize to zeros
    edges = np.pad(edges, ((0, pad), (0, 0), (0, 0)))
    emask = np.pad(emask, ((0, pad), (0, 0)))
    per = edges.shape[0] // len(devices)
    parts = [_availability_on(cutout, dev, edges[k * per:(k + 1) * per],
                              emask[k * per:(k + 1) * per], excluder, row_tile, max_device_pixels)
             for k, dev in enumerate(devices)]
    return np.concatenate(parts)[:S]


def _availability_on(cutout, device, edges, emask, excluder, row_tile, max_device_pixels):
    """availability_matrix_device's path on one device for the shapes'
    (S, E, 4) edges and (S, E) edge mask."""
    from atlite_tpu_torch.gis.crs import normalize_crs as _ncrs, transform_points
    from atlite_tpu_torch.gis.raster import overlap_matrix, padded_transform_and_shape

    crs = excluder.crs
    res = excluder.res

    # fine lattice covering the cutout extent, snapped to the res lattice.
    # Sample the extent BOUNDARY densely, not just the corners: under a
    # curved CRS (e.g. 4326 -> LAEA) an edge's extremum lies mid-edge, and
    # corner-only bounds would clip fine pixels off boundary cells.
    g = cutout.grid_desc
    x0, x1, y0, y1 = g.extent
    exs = np.linspace(x0, x1, 65)
    eys = np.linspace(y0, y1, 65)
    edge_x = np.concatenate([exs, exs, np.full(65, x0), np.full(65, x1)])
    edge_y = np.concatenate([np.full(65, y0), np.full(65, y1), eys, eys])
    cx, cy = transform_points(edge_x, edge_y, cutout.crs, crs)
    bounds = (cx.min() - res, cy.min() - res, cx.max() + res, cy.max() + res)
    transform, (ny, nx) = padded_transform_and_shape(bounds, res)
    px = transform.c + transform.a * (np.arange(nx) + 0.5)
    py = transform.f + transform.e * (np.arange(ny) + 0.5)  # descending

    # the exclusion mask is shape-independent: cached on the excluder,
    # keyed by the device, the lattice and the layers
    def _codes_key(codes):
        if codes is None:
            return None
        if callable(codes):
            return ("fn", id(codes))
        return tuple(np.atleast_1d(codes).tolist())

    cache_key = (
        str(device), tuple(transform), ny, nx,
        tuple((id(d["raster"]), _codes_key(d["codes"]), d["buffer"],
               d["invert"], d["nodata"]) for d in excluder.rasters),
        tuple((id(d["geometry"]), d["buffer"], d["invert"])
              for d in excluder.geometries),
    )
    S = edges.shape[0]
    edges_d = torch.as_tensor(edges, dtype=torch.float32, device=device)
    emask_d = torch.as_tensor(emask, device=device)
    px_d = torch.as_tensor(px, dtype=torch.float32, device=device)
    py_d = torch.as_tensor(py, dtype=torch.float32, device=device)

    # stream over fine-row blocks so device memory stays bounded whatever
    # the fine raster's size: in the excluder's CRS a block's per-shape
    # masks, S x rows x nx; across CRSs, where no per-shape mask is made,
    # its pixels (max_device_pixels / PIXEL_BYTES of them) and its
    # (S, rows, E) crossings
    same_crs = _ncrs(crs) == _ncrs(cutout.crs)
    if same_crs:
        row_block = max_device_pixels // max(S * nx, 1)
    else:
        row_block = min(max_device_pixels // max(PIXEL_BYTES * nx, 1),
                        _TILE_ELEMS // max(S * edges.shape[1], 1))
    row_block = max(row_tile, min(ny, row_block))
    row_block = -(-row_block // row_tile) * row_tile
    blocks = [(b0, min(b0 + row_block, ny)) for b0 in range(0, ny, row_block)]

    # A warm call (same key) reuses the cold build's per-block device
    # parts, one copy of the mask.  A COLD call builds it PER ROW BLOCK on
    # one background thread, ships each block as packed bits through
    # pinned staging and unpacks it on the device, so the host mask build,
    # the upload and the device work of consecutive blocks overlap.
    cached = getattr(excluder, "_fine_mask_cache", None)
    if cached is not None and cached[0] == cache_key:
        get_excl = _excl_from_parts(cached[1])
        finish_excl = lambda: None  # noqa: E731
    elif any(callable(d["codes"]) for d in excluder.rasters):
        # a CALLABLE code filter gets handed the projected array and need
        # not be pointwise — per-block windows would change its input, so
        # build the full lattice in one shot
        from atlite_tpu_torch.gis.exclusion import build_exclusion_mask

        exclusions = build_exclusion_mask(excluder, transform, (ny, nx))
        packed = _Uploader(device)(np.packbits(exclusions))
        excl_full = _unpack_mask_device(packed, ny * nx).reshape(ny, nx)
        excluder._fine_mask_cache = (cache_key, {(0, ny): excl_full})
        get_excl = lambda b0, b1: excl_full[b0:b1]  # noqa: E731
        finish_excl = lambda: None  # noqa: E731
    else:
        from atlite_tpu_torch.core.grid import Affine
        from atlite_tpu_torch.gis.exclusion import (
            _bounds_overlap, _native_code_mask, build_exclusion_mask,
        )

        # the allow_no_overlap contract applies to the FULL window — a
        # raster missing one block only must not raise
        window_bounds = (transform.c, transform.f + transform.e * ny,
                         transform.c + transform.a * nx, transform.f)
        for d in excluder.rasters:
            if not _bounds_overlap(d["raster"], window_bounds, crs) \
                    and not d["allow_no_overlap"]:
                raise ValueError(
                    "Raster and geometry do not overlap; pass "
                    "allow_no_overlap=True to allow this.")
            _native_code_mask(d)  # prime the shared native-mask cache
        blk_exc = _BlockExcluder(excluder)
        # geometry-layer dilation reaches across block edges: build with
        # a margin and crop (buffered rasters are refused above)
        margin = max([int(d["buffer"] / res) + 1
                      for d in excluder.geometries if d["buffer"]] + [0])

        def _build(b0, b1):
            # a profiler range on the worker thread: the host's build ms
            # of each block, in a trace of the call
            with span("mask", b0, b1):
                m0, m1 = max(b0 - margin, 0), min(b1 + margin, ny)
                sub_t = Affine(transform.a, 0.0, transform.c,
                               0.0, transform.e, transform.f + transform.e * m0)
                m = build_exclusion_mask(blk_exc, sub_t, (m1 - m0, nx))
                return np.packbits(m[b0 - m0:b0 - m0 + (b1 - b0)])

        cold = _ColdMask(blocks, _build, nx, device, excluder, cache_key)
        get_excl, finish_excl = cold.get, cold.finish

    tr = g.transform_r
    NY, NX = g.shape

    if same_crs:
        # separable exact area-average: two overlap-matrix products
        Wx_np = overlap_matrix(transform.c, transform.a, nx, tr.c, tr.a, NX).astype(np.float32)
        Wy_full = overlap_matrix(transform.f, transform.e, ny, tr.f, tr.e, NY)
        den = Wy_full.sum(axis=1)[:, None] * Wx_np.sum(axis=1)[None, :]
        Wx = torch.as_tensor(Wx_np, device=device)
        Wy_d = torch.as_tensor(Wy_full, dtype=torch.float32, device=device)

        num = None
        try:
            for b0, b1 in blocks:
                part = _block_partial(edges_d, emask_d, px_d, py_d[b0:b1], get_excl(b0, b1),
                                      Wy_d[:, b0:b1], Wx, row_tile=row_tile)
                num = part if num is None else num + part
        finally:
            finish_excl()
        with np.errstate(invalid="ignore"):
            avail = num.cpu().numpy() / den[None]
        avail[:, den <= 0] = 0.0
        return np.ascontiguousarray(avail[:, ::-1])  # flip to ascending y

    # cross-CRS (e.g. 100 m EPSG:3035 excluder onto a 4326 cutout): the
    # fine->cell mapping is not separable, so every block's pixels map to
    # cells via closed-form CRS math and are counted per cell on the
    # device (center-point scatter-mean, the same semantics as the host
    # path's cross-CRS reproject_average).
    ncell = NY * NX
    inv = g.transform_r.inverse
    inv_affine = torch.tensor([inv.a, inv.b, inv.c, inv.d, inv.e, inv.f],
                              dtype=torch.float32, device=device)
    src_key = _ncrs(crs)
    dst_key = _ncrs(cutout.crs)

    # per-block cutout-row windows from f64 boundary sampling (+margin);
    # one window height for every block
    def block_rows(b0, b1):
        xs = np.concatenate([px[::max(1, nx // 64)], px[-1:]])
        ys = np.concatenate([py[b0:b1:max(1, (b1 - b0) // 16)], py[b1 - 1:b1]])
        gx, gy = np.meshgrid(xs, ys)
        cxs, cys = transform_points(gx.ravel(), gy.ravel(), crs, cutout.crs)
        ri = np.floor(inv.d * cxs + inv.e * cys + inv.f)
        return int(ri.min()) - 2, int(ri.max()) + 3

    windows = [block_rows(b0, b1) for b0, b1 in blocks]
    yspan = max(hi - lo for lo, hi in windows)
    bins = yspan * NX + 1

    # dispatch every block first, accumulating on the device; THEN read
    # the dropped counters back once — checking them eagerly would force
    # one device sync per block
    num_d = torch.zeros((S, ncell), dtype=torch.int64, device=device)
    cnt_d = torch.zeros(ncell, dtype=torch.int64, device=device)
    pending = []
    excl_blocks = {}
    try:
        for (b0, b1), (lo, _) in zip(blocks, windows):
            lo = max(min(lo, NY - yspan), 0) if NY > yspan else 0
            excl_blocks[(b0, b1)] = get_excl(b0, b1)
            num_b, cnt_b, dropped = _block_cells_crosscrs(
                edges_d, emask_d, px_d, py_d[b0:b1], excl_blocks[(b0, b1)], inv_affine, lo,
                src_crs=src_key, dst_crs=dst_key, NX=NX, NY=NY, bins=bins)
            sl = slice(lo * NX, (lo + min(yspan, NY - lo)) * NX)
            num_d[:, sl] += num_b[:, :sl.stop - sl.start]
            cnt_d[sl] += cnt_b[:sl.stop - sl.start]
            pending.append(((b0, b1), sl, num_b, cnt_b, dropped))
    finally:
        finish_excl()

    dropped_all = torch.stack([p[-1] for p in pending]).cpu().numpy() if pending else []
    redo = []
    for ((b0, b1), sl, num_b, cnt_b, _), n_dropped in zip(pending, dropped_all):
        if n_dropped > 0:
            # the sampled row window missed in-cutout pixels (extreme
            # projection curvature) — take this block's counts out and
            # redo it with the exact host scatter so nothing is lost
            logger.warning(
                "cross-CRS availability: row window missed %d pixels in "
                "block %d:%d; falling back to host scatter for it",
                int(n_dropped), b0, b1)
            num_d[:, sl] -= num_b[:, :sl.stop - sl.start]
            cnt_d[sl] -= cnt_b[:sl.stop - sl.start]
            redo.append((b0, b1))
    num = num_d.cpu().numpy().astype(np.float64)
    cnt = cnt_d.cpu().numpy().astype(np.float64)
    for b0, b1 in redo:
        fine = _block_masks(edges_d, emask_d, px_d, py_d[b0:b1], excl_blocks[(b0, b1)],
                            row_tile=row_tile).cpu().numpy()
        gx, gy = np.meshgrid(px, py[b0:b1])
        cxs, cys = transform_points(gx.ravel(), gy.ravel(), crs, cutout.crs)
        ci = np.floor(inv.a * cxs + inv.b * cys + inv.c).astype(np.int64)
        ri = np.floor(inv.d * cxs + inv.e * cys + inv.f).astype(np.int64)
        okm = (ci >= 0) & (ci < NX) & (ri >= 0) & (ri < NY)
        cid = ri[okm] * NX + ci[okm]
        cnt += np.bincount(cid, minlength=ncell)
        flat = fine.reshape(S, -1)[:, okm]
        for s in range(S):
            num[s] += np.bincount(cid, weights=flat[s], minlength=ncell)
    with np.errstate(invalid="ignore"):
        avail = num / cnt[None]
    avail[:, cnt <= 0] = 0.0
    return np.ascontiguousarray(avail.reshape(S, NY, NX)[:, ::-1])
