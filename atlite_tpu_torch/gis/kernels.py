"""Device path of the availability matrix (counterpart of
``atlite_tpu/gis/kernels.py``), plain PyTorch on the cutout's device.

Instead of atlite's per-shape loop of GDAL rasterize + warp (a
multiprocessing Pool, its gis.py:661-756), each shape is worked in its own
window, the fine lattice that the host path gives it
(``padded_transform_and_shape`` of its bounds), and the windows go to the
device in batches of shapes:

1. rasterize every shape of a batch at once: even-odd crossings at the
   window's pixel centres, in float64, the host path's own comparison;
2. exclusions of the window, per layer (``build_exclusion_mask``'s
   semantics): a raster in the excluder's CRS at its resolution and
   aligned to its lattice, of a narrow integer type with listed codes, is
   sampled on the device by an integer offset and its codes selected by
   a lookup table, cropped to the shape (outside it, the layer's nodata),
   inverted, and dilated ``int(buffer / res) + 1`` times by the
   4-connected cross; a buffered layer of any other kind is built on the
   host for each window (cropped likewise); unbuffered host layers and
   geometry layers are shape-independent, built once on the host over
   the lattice of the touched cells and cached on the excluder;
3. downsample onto the cutout grid: in the excluder's CRS, two
   overlap-matrix products, ``Wy @ mask @ Wx.T`` (full float32 products,
   TF32 off); across CRSs, every fine pixel centre of the touched cells is
   mapped to its cell once a call by the closed-form CRS math on the
   device (float32, as the JAX package does on its chip), and each
   window's available pixels are counted per cell from prefix sums along
   its rows, taken at the ends of its runs of one cell (exact integers).

Every cell a window touches counts all of its pixels (atlite's
``pad_extent``): the fine lattice covers the whole cells that the windows
touch, so the result equals that of one lattice over the cutout's extent,
while the work scales with the windows' area.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from atlite_tpu_torch.core.device import PinnedRing, fp32_matmul
from atlite_tpu_torch.gis import geometry as G
from atlite_tpu_torch.profiling import span

# elements of the (shapes, rows, edges) crossing table of one row tile
_TILE_ELEMS = 1 << 24
# a block of the cell lattice holds max_device_pixels / PIXEL_BYTES fine
# pixels: each carries the CRS math's float32 temporaries, where a
# pixel-shape of a batch of windows carries a few bytes of masks
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
    guarded division and its order of operations).  ``yb`` is (rows,), or
    (S, rows) with each shape's own rows."""
    x1, y1, x2, y2 = (edges[..., i][:, None, :] for i in range(4))
    yb = yb[None, :, None] if yb.dim() == 1 else yb[:, :, None]
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
    wraps, its parity holds) in place.  ``px`` (nx,) and ``py`` (ny,) are
    shared by the shapes, or (S, nx) and (S, ny), each shape's own."""
    S, E = edge_mask.shape
    ny, nx = py.shape[-1], px.shape[-1]
    tile = min(max(ny, 1), max(row_tile, _TILE_ELEMS // max(S * E, 1)))
    out = None if tile >= ny else torch.empty((S, ny, nx), dtype=torch.bool, device=px.device)
    for r0 in range(0, ny, tile):
        yb = py[..., r0:r0 + tile]
        xint = _crossings(edges, edge_mask, yb)
        if px.dim() == 1:
            j = torch.searchsorted(px, xint)
        else:
            j = torch.searchsorted(px, xint.reshape(S, -1)).reshape(xint.shape)
        keep = (j < nx).to(torch.uint8)  # j == nx: right of every centre
        flips = torch.zeros((S, yb.shape[-1], nx), dtype=torch.uint8, device=px.device)
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


def _unpack_mask_device(packed, n):
    """np.packbits mirror on the device: (bytes,) uint8 -> (n,) bool by
    elementwise shifts."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n].bool()


class _BlockExcluder:
    """Read-only view of some layers of an ExclusionContainer (by default
    all) for the host builds of a block or a window: rasters carry
    allow_no_overlap=True (the overlap contract was already validated
    against the whole lattice — a raster merely missing one block must not
    raise) while the layer dict copies share the cached native code
    masks."""

    def __init__(self, exc, rasters=None, geometries=None):
        rasters = exc.rasters if rasters is None else rasters
        self.rasters = [dict(d, allow_no_overlap=True) for d in rasters]
        self.geometries = exc.geometries if geometries is None else geometries
        self.res = exc.res
        self.crs = exc.crs
        self.all_open = True


def availability_matrix_device(cutout, shapes_geoms, excluder,
                               shapes_crs=4326, row_tile=64,
                               max_device_pixels=64_000_000, mesh=None):
    """Full availability matrix on the cutout's device (a CUDA card, or the
    CPU), with the host path's semantics, buffered raster layers included
    (cropped to each shape before their dilation, as atlite does).
    Returns (S, Y, X) numpy (ascending y, like compute_availabilitymatrix).

    The shapes' windows go to the device in batches of one count, as few
    as keep each within ``max_device_pixels`` pixel-shapes at the largest
    window's size (a single larger window goes alone); the counts stay on
    the device and are read back once, after the last batch.  ``row_tile``
    is the least number of rows the rasterization takes at a time.

    ``mesh`` (a ``core.mesh.Mesh``): the shapes are split over the mesh's
    devices (this process's), one group of shapes a device in mesh order
    (the multi-device counterpart of atlite's Pool over shapes); each
    device runs the same path on its group, in turn, and the groups are
    joined.  The excluder caches its shape-independent host mask for one
    device (the last), so positions on one card share it and a second card
    builds its own.

    Counters: ``availability_matrix_device.shape_windows`` (windows worked)
    and ``.window_pixels`` (their fine pixels).
    """
    from atlite_tpu_torch.core.mesh import Mesh
    from atlite_tpu_torch.gis.exclusion import _as_geometry_list

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a core.mesh.Mesh, not {type(mesh).__name__}")
    if not excluder.all_open:
        excluder.open_files()
    geoms = _as_geometry_list(shapes_geoms, shapes_crs, excluder.crs)
    if mesh is None:
        return _availability_on(cutout, cutout.device, geoms, excluder, row_tile,
                                max_device_pixels)
    devices = list(mesh.devices.ravel())
    per = -(-len(geoms) // len(devices))
    parts = [_availability_on(cutout, dev, geoms[k * per:(k + 1) * per], excluder, row_tile,
                              max_device_pixels)
             for k, dev in enumerate(devices)]
    return np.concatenate(parts)


availability_matrix_device.shape_windows = 0
availability_matrix_device.window_pixels = 0
_counted = availability_matrix_device  # the counters' home, whatever wraps the name


def _lattice_index(v, res):
    """The integer index of a res-snapped coordinate (an exact multiple)."""
    return int(round(v / res))


def _device_layer(d, res, crs):
    """Whether a raster layer runs on the device: in the excluder's CRS, at
    its resolution, aligned to its lattice (an integer offset samples it,
    the host's slice), of an integer or boolean type of at most 16 bits
    (its codes a lookup table), and without a callable code filter."""
    from atlite_tpu_torch.gis.crs import normalize_crs

    r = d["raster"]
    t = r.transform
    data = np.asarray(r.data)
    if callable(d["codes"]) or data.ndim != 2 or data.dtype.kind not in "uib" \
            or data.dtype.itemsize > 2:
        return False
    if normalize_crs(r.crs) != normalize_crs(crs) or t.b != 0 or t.d != 0 \
            or t.a != res or t.e != -res:
        return False
    return all(abs(v / res - round(v / res)) < 1e-9 for v in (t.c, t.f))


class _DeviceRaster:
    """One raster's rows and columns under the lattice, on the device
    (uploaded once a call, whatever number of layers read it), and the
    offsets that place a window's pixels in it."""

    def __init__(self, r, res, KX0, KY0, ny, nx, device):
        data = np.asarray(r.data)
        H, W = data.shape
        self.rx, self.ry = _lattice_index(r.transform.c, res), _lattice_index(r.transform.f, res)
        # raster row of lattice row i: ry - KY0 + i; column of j: KX0 - rx + j
        r0, r1 = max(self.ry - KY0, 0), min(self.ry - KY0 + ny, H)
        c0, c1 = max(KX0 - self.rx, 0), min(KX0 - self.rx + nx, W)
        self.r0, self.c0 = r0, c0
        if r1 <= r0 or c1 <= c0:
            self.tile = None
            return
        # whole rows are one contiguous read; a narrow window is copied out
        part = data[r0:r1] if (c1 - c0) * 4 >= 3 * W else np.ascontiguousarray(data[r0:r1, c0:c1])
        with span("copy", r0, r1):
            tile = torch.from_numpy(part).to(device)
        self.tile = tile if part.shape[1] == c1 - c0 else tile[:, c0:c1]

    def sample(self, ky, kx, ny, nx):
        """(values (S, ny, nx), inside the raster (S, ny, nx) bool) of the
        windows with top-left lattice indices ``ky``/``kx`` (S,) tensors."""
        dev = ky.device
        S = ky.shape[0]
        if self.tile is None:
            return None, torch.zeros((S, ny, nx), dtype=torch.bool, device=dev)
        h, w = self.tile.shape
        rows = (self.ry - ky)[:, None] + torch.arange(ny, device=dev)[None, :] - self.r0
        cols = (kx - self.rx)[:, None] + torch.arange(nx, device=dev)[None, :] - self.c0
        rok, cok = (rows >= 0) & (rows < h), (cols >= 0) & (cols < w)
        vals = self.tile[rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
        return vals, rok[:, :, None] & cok[:, None, :]


def _code_table(d, device):
    """(lookup table over the raster type's values, its lowest value, the
    layer's nodata selected) of a device layer: the host's own code test
    (``_code_select``) over every value of the type."""
    from atlite_tpu_torch.gis.exclusion import _code_select, _nodata_selected

    dtype = np.asarray(d["raster"].data).dtype
    lo, hi = (0, 1) if dtype.kind == "b" else (np.iinfo(dtype).min, np.iinfo(dtype).max)
    values = np.arange(lo, hi + 1).astype(dtype)
    table = torch.as_tensor(_code_select(values, d["codes"]), device=device)
    return table, int(lo), _nodata_selected(d)


def _dilation_iterations(buffer, res):
    """scipy's iterations of the 4-connected cross for a buffer (atlite
    gis.py:317): ``int(buffer / res) + 1``."""
    return int(buffer / res) + 1


def _crop(sel, inside, nodata):
    """atlite's crop (``projected_mask`` with ``crop=True``): outside the
    shape a layer reads its nodata, whose selection is ``nodata``."""
    return torch.where(inside, sel, nodata)


def _dilate(m, iterations):
    """4-connected binary dilation of each (ny, nx) mask of ``m`` (S, ny,
    nx), ``iterations`` times, nothing beyond the edges (scipy's
    ``binary_dilation`` with its default border)."""
    for _ in range(iterations):
        out = m.clone()
        out[:, 1:] |= m[:, :-1]
        out[:, :-1] |= m[:, 1:]
        out[:, :, 1:] |= m[:, :, :-1]
        out[:, :, :-1] |= m[:, :, 1:]
        m = out
    return m


def _windows_cells(wins, res, cutout, crs, same_crs):
    """Per window (its transform and shape) the inclusive (ri0, ri1, ci0,
    ci1) range of cutout cells (top-down rows) its pixels can reach, from
    its boundary sampled in the cutout's CRS (a hundredth of a cell to
    spare for an edge that bulges between samples), or None outside the
    cutout."""
    from atlite_tpu_torch.gis.crs import transform_points

    g = cutout.grid_desc
    NY, NX = g.shape
    inv = g.transform_r.inverse
    n = 2 if same_crs else 33
    s = np.linspace(0.0, 1.0, n)
    xs, ys = [], []
    for t, (ny, nx) in wins:
        x0, x1 = t.c, t.c + t.a * nx
        y1, y0 = t.f, t.f + t.e * ny
        xs.append(np.concatenate([x0 + (x1 - x0) * s, x0 + (x1 - x0) * s, np.full(n, x0),
                                  np.full(n, x1)]))
        ys.append(np.concatenate([np.full(n, y0), np.full(n, y1), y0 + (y1 - y0) * s,
                                  y0 + (y1 - y0) * s]))
    xs, ys = np.stack(xs), np.stack(ys)
    if not same_crs:
        xs, ys = transform_points(xs.ravel(), ys.ravel(), crs, cutout.crs)
        xs, ys = xs.reshape(len(wins), -1), ys.reshape(len(wins), -1)
    ci = inv.a * xs + inv.b * ys + inv.c
    ri = inv.d * xs + inv.e * ys + inv.f
    pad = 0.0 if same_crs else 0.01
    out = []
    for k in range(len(wins)):
        lo_r, hi_r = np.floor(np.nanmin(ri[k]) - pad), np.floor(np.nanmax(ri[k]) + pad)
        lo_c, hi_c = np.floor(np.nanmin(ci[k]) - pad), np.floor(np.nanmax(ci[k]) + pad)
        if not np.isfinite([lo_r, hi_r, lo_c, hi_c]).all() or hi_r < 0 or lo_r > NY - 1 \
                or hi_c < 0 or lo_c > NX - 1:
            out.append(None)
            continue
        out.append((int(max(lo_r, 0)), int(min(hi_r, NY - 1)), int(max(lo_c, 0)),
                    int(min(hi_c, NX - 1))))
    return out


def _availability_on(cutout, device, geoms, excluder, row_tile, max_device_pixels):
    """availability_matrix_device's path on one device for the shapes
    ``geoms`` in the excluder's CRS."""
    from atlite_tpu_torch.gis.crs import normalize_crs as _ncrs, transform_points
    from atlite_tpu_torch.gis.raster import overlap_matrix, padded_transform_and_shape

    crs, res = excluder.crs, excluder.res
    g = cutout.grid_desc
    NY, NX = g.shape
    S = len(geoms)
    out = np.zeros((S, NY, NX))
    if S == 0:
        return out
    same_crs = _ncrs(crs) == _ncrs(cutout.crs)

    # each shape's window: the fine lattice the host path gives it
    wins = [padded_transform_and_shape(geom.bounds, res) for geom in geoms]
    cells = _windows_cells(wins, res, cutout, crs, same_crs)
    work = [k for k in range(S) if cells[k] is not None]
    if not work:
        return out
    ri0 = min(cells[k][0] for k in work)
    ri1 = max(cells[k][1] for k in work)
    ci0 = min(cells[k][2] for k in work)
    ci1 = max(cells[k][3] for k in work)
    nRy, nRx = ri1 - ri0 + 1, ci1 - ci0 + 1

    # the lattice: the windows and the whole cells they touch, the cells'
    # boundary sampled densely (under a curved CRS an edge's extremum lies
    # mid-edge, and corner-only bounds would clip pixels off a cell)
    tr = g.transform_r
    x0, x1 = tr.c + tr.a * ci0, tr.c + tr.a * (ci1 + 1)
    y1, y0 = tr.f + tr.e * ri0, tr.f + tr.e * (ri1 + 1)
    exs, eys = np.linspace(x0, x1, 65), np.linspace(y0, y1, 65)
    cx, cy = transform_points(np.concatenate([exs, exs, np.full(65, x0), np.full(65, x1)]),
                              np.concatenate([np.full(65, y0), np.full(65, y1), eys, eys]),
                              cutout.crs, crs)
    wb = np.array([(t.c, t.f + t.e * n[0], t.c + t.a * n[1], t.f)
                   for (t, n), c in zip(wins, cells) if c is not None])
    bounds = (min(cx.min() - res, wb[:, 0].min()), min(cy.min() - res, wb[:, 1].min()),
              max(cx.max() + res, wb[:, 2].max()), max(cy.max() + res, wb[:, 3].max()))
    tL, (nyL, nxL) = padded_transform_and_shape(bounds, res)
    layers = _prepare_layers(excluder, tL, nyL, nxL, device, row_tile, max_device_pixels)

    # the cell of every pixel (across CRSs) or the overlap weights (one CRS)
    if same_crs:
        Wx = overlap_matrix(tL.c, tL.a, nxL, tr.c, tr.a, NX)[ci0:ci1 + 1].astype(np.float32)
        Wy64 = overlap_matrix(tL.f, tL.e, nyL, tr.f, tr.e, NY)[ri0:ri1 + 1]
        den = Wy64.sum(axis=1)[:, None] * Wx.sum(axis=1)[None, :]
        Wx_d = torch.as_tensor(Wx, device=device)
        Wy_d = torch.as_tensor(Wy64, dtype=torch.float32, device=device)
        num = torch.zeros((S, nRy, nRx), dtype=torch.float32, device=device)
    else:
        ids_L, cnt = _cell_lattice(tL, nyL, nxL, cutout, crs, (ri0, ci0, nRy, nRx), device,
                                   max_device_pixels)
        num = torch.zeros((S, nRy * nRx + 1), dtype=torch.int64, device=device)

    # batches of windows of one count, as few as keep each within
    # max_device_pixels pixel-shapes at the largest window's size
    largest = max(wins[k][1][0] * wins[k][1][1] for k in work)
    n_batches = min(len(work), -(-len(work) * largest // max_device_pixels))
    per = -(-len(work) // n_batches)
    batches = [work[i:i + per] for i in range(0, len(work), per)]

    for batch in batches:
        with span("aggregate", batch[0], batch[-1] + 1):
            inside, excl, ky, kx = _window_masks(
                [geoms[k] for k in batch], [wins[k] for k in batch], batch, layers, res,
                device, row_tile)
            avail = inside & ~excl
            del inside, excl
            Sb, ny_b, nx_b = avail.shape
            oy, ox = layers.KY0 - ky, kx - layers.KX0  # the windows' offsets in the lattice
            rows = oy[:, None] + torch.arange(ny_b, device=device)[None, :]
            cols = ox[:, None] + torch.arange(nx_b, device=device)[None, :]
            rok, cok = rows < nyL, cols < nxL
            rows, cols = rows.clamp(max=nyL - 1), cols.clamp(max=nxL - 1)
            sel = torch.as_tensor(batch, device=device)
            if same_crs:
                wy = Wy_d[:, rows].permute(1, 0, 2) * rok[:, None, :]
                wx = Wx_d[:, cols].permute(1, 0, 2) * cok[:, None, :]
                with fp32_matmul():
                    num[sel] = wy @ (avail.to(torch.float32) @ wx.transpose(1, 2))
            else:
                ids = ids_L[rows[:, :, None], cols[:, None, :]]
                _count_runs(num, sel, avail, ids)
        _counted.shape_windows += len(batch)
        _counted.window_pixels += sum(wins[k][1][0] * wins[k][1][1] for k in batch)

    if same_crs:
        with np.errstate(invalid="ignore"):
            share = num.cpu().numpy() / den[None]
        share[:, den <= 0] = 0.0
    else:
        n = num.cpu().numpy()[:, :-1].astype(np.float64)
        c = cnt.cpu().numpy()[:-1].astype(np.float64)
        with np.errstate(invalid="ignore"):
            share = n / c[None]
        share[:, c <= 0] = 0.0
        share = share.reshape(S, nRy, nRx)
    out[:, ri0:ri1 + 1, ci0:ci1 + 1] = share
    return np.ascontiguousarray(out[:, ::-1])  # flip to ascending y


def _prepare_layers(excluder, tL, nyL, nxL, device, row_tile, max_device_pixels):
    """The excluder's layers over the lattice ``tL`` (nyL, nxL): the
    overlap check, the device rasters (each uploaded once), the buffered
    host layers built window by window, and the shape-independent host
    mask.  Returns a namespace for ``_window_masks``."""
    from types import SimpleNamespace

    from atlite_tpu_torch.gis.exclusion import _bounds_overlap

    crs, res = excluder.crs, excluder.res
    KX0, KY0 = _lattice_index(tL.c, res), _lattice_index(tL.f, res)
    lattice_bounds = (tL.c, tL.f + tL.e * nyL, tL.c + tL.a * nxL, tL.f)
    for d in excluder.rasters:
        if not d["allow_no_overlap"] and not _bounds_overlap(d["raster"], lattice_bounds, crs):
            raise ValueError("Raster and geometry do not overlap; pass "
                             "allow_no_overlap=True to allow this.")
    on_device = [d for d in excluder.rasters if _device_layer(d, res, crs)]
    host = [d for d in excluder.rasters if not any(d is e for e in on_device)]
    shared = [d for d in host if not d["buffer"]]
    rasters, device_layers = {}, []
    for d in on_device:
        key = (id(np.asarray(d["raster"].data)), tuple(d["raster"].transform))
        if key not in rasters:
            rasters[key] = _DeviceRaster(d["raster"], res, KX0, KY0, nyL, nxL, device)
        device_layers.append((rasters[key], *_code_table(d, device), d))
    per_window = [d for d in host if d["buffer"]]
    return SimpleNamespace(
        device=device_layers, KX0=KX0, KY0=KY0,
        per_window=_BlockExcluder(excluder, rasters=per_window, geometries=[])
        if per_window else None,
        shared=_shared_mask(excluder, shared, tL, nyL, nxL, device, row_tile, max_device_pixels)
        if shared or excluder.geometries else None)


def _window_masks(geoms, wins, index, layers, res, device, row_tile):
    """(inside, excluded) (Sb, ny, nx) bool of a batch of windows (padded
    to the batch's largest; padding is neither), and the windows' top-left
    lattice indices (ky, kx) as (Sb,) int64 tensors.  ``index``: the
    shapes' numbers, for the spans."""
    from atlite_tpu_torch.gis.exclusion import build_exclusion_mask

    Sb = len(geoms)
    ny_b = max(n[0] for _, n in wins)
    nx_b = max(n[1] for _, n in wins)
    f64 = dict(dtype=torch.float64, device=device)
    ky = torch.tensor([_lattice_index(t.f, res) for t, _ in wins], device=device)
    kx = torch.tensor([_lattice_index(t.c, res) for t, _ in wins], device=device)
    nys = torch.tensor([n[0] for _, n in wins], device=device)
    nxs = torch.tensor([n[1] for _, n in wins], device=device)
    valid = (torch.arange(ny_b, device=device)[None, :] < nys[:, None])[:, :, None] \
        & (torch.arange(nx_b, device=device)[None, :] < nxs[:, None])[:, None, :]
    # pixel centres from each window's own origin, as the host computes them
    left = torch.tensor([t.c for t, _ in wins], **f64)[:, None]
    top = torch.tensor([t.f for t, _ in wins], **f64)[:, None]
    px = torch.arange(nx_b, **f64)[None, :] + 0.5
    py = torch.arange(ny_b, **f64)[None, :] + 0.5
    px = torch.where(px < nxs[:, None], res * px + left, torch.inf)
    py = -res * py + top
    edges, emask = shapes_to_edges(geoms)
    inside = _rasterize(torch.as_tensor(edges, **f64), torch.as_tensor(emask, device=device),
                        px, py, row_tile) & valid
    excl = torch.zeros((Sb, ny_b, nx_b), dtype=torch.bool, device=device)
    samples = {}
    for raster, table, lo, nodata, d in layers.device:
        if id(raster) not in samples:
            samples[id(raster)] = raster.sample(ky, kx, ny_b, nx_b)
        vals, in_raster = samples[id(raster)]
        sel = torch.full_like(excl, nodata) if vals is None else \
            torch.where(in_raster, table[vals.int() - lo if lo else vals.int()], nodata)
        sel = _crop(sel, inside, nodata)
        if d["invert"]:
            sel = ~sel
        sel &= valid
        if d["buffer"]:
            sel = _dilate(sel, _dilation_iterations(d["buffer"], res))
        excl |= sel
    if layers.per_window is not None:
        for i, (geom, (t, n)) in enumerate(zip(geoms, wins)):
            with span("mask", index[i], index[i] + 1):
                m = build_exclusion_mask(layers.per_window, t, n, crop_geoms=[geom])
            excl[i, :n[0], :n[1]] |= torch.as_tensor(m, device=device)
    if layers.shared is not None:
        nyL, nxL = layers.shared.shape
        rows = (layers.KY0 - ky)[:, None] + torch.arange(ny_b, device=device)[None, :]
        cols = (kx - layers.KX0)[:, None] + torch.arange(nx_b, device=device)[None, :]
        excl |= layers.shared[rows.clamp(max=nyL - 1)[:, :, None],
                              cols.clamp(max=nxL - 1)[:, None, :]]
    return inside, excl & valid, ky, kx


def _count_runs(num, sel, avail, ids):
    """Add each window's available pixels per cell to ``num`` (S, bins)
    rows ``sel``: along a row the cell id changes in runs, and a run's
    count is the row's prefix count of available pixels at its end minus
    that at the previous run's end.  Finding the run ends waits for the
    device once."""
    P = torch.cumsum(avail, dim=2, dtype=torch.int32)
    end = torch.ones_like(avail)
    end[:, :, :-1] = ids[:, :, 1:] != ids[:, :, :-1]
    s, r, c = torch.nonzero(end, as_tuple=True)
    at = P[s, r, c]
    same = (s[1:] == s[:-1]) & (r[1:] == r[:-1])
    prev = torch.zeros_like(at)
    prev[1:] = torch.where(same, at[:-1], 0)
    num.index_put_((sel[s], ids[s, r, c].to(torch.int64)), (at - prev).to(torch.int64),
                   accumulate=True)


def _cell_lattice(tL, nyL, nxL, cutout, crs, rect, device, max_device_pixels):
    """(ids (nyL, nxL) int32, cnt (bins,) int64) of the lattice: each pixel
    centre's cell in the rectangle ``rect`` = (ri0, ci0, nRy, nRx) of cutout
    cells (top-down), by the closed-form CRS math on the device in float32,
    ``nRy * nRx`` (the last bin) outside it; and the pixels of each bin."""
    from atlite_tpu_torch.gis.crs import normalize_crs as _ncrs, transform_points_xp

    ri0, ci0, nRy, nRx = rect
    inv = cutout.grid_desc.transform_r.inverse
    a, b, c, d, e, f = torch.tensor([inv.a, inv.b, inv.c, inv.d, inv.e, inv.f],
                                    dtype=torch.float32, device=device)
    px = torch.as_tensor(tL.c + tL.a * (np.arange(nxL) + 0.5), dtype=torch.float32,
                         device=device)
    py = torch.as_tensor(tL.f + tL.e * (np.arange(nyL) + 0.5), dtype=torch.float32,
                         device=device)
    src, dst = _ncrs(crs), _ncrs(cutout.crs)
    bins = nRy * nRx
    ids = torch.empty((nyL, nxL), dtype=torch.int32, device=device)
    rows = max(1, max_device_pixels // (PIXEL_BYTES * nxL))
    for r0 in range(0, nyL, rows):
        r1 = min(r0 + rows, nyL)
        with span("pack", r0, r1):
            # whole (rows, nx) operands: a CPU's vector loop rounds
            # transcendentals apart from its scalar tail, and broadcast
            # operands give every row a tail, at columns that depend on
            # where the lattice starts
            shape = (r1 - r0, nxL)
            lon, lat = transform_points_xp(px[None, :].expand(shape).contiguous(),
                                           py[r0:r1, None].expand(shape).contiguous(),
                                           src, dst, torch)
            ci = torch.floor(a * lon + b * lat + c).to(torch.int32) - ci0
            ri = torch.floor(d * lon + e * lat + f).to(torch.int32) - ri0
            ok = (ci >= 0) & (ci < nRx) & (ri >= 0) & (ri < nRy)
            ids[r0:r1] = torch.where(ok, ri * nRx + ci, bins)
    cnt = torch.bincount(ids.view(-1), minlength=bins + 1)
    return ids, cnt


def _shared_mask(excluder, layers, tL, nyL, nxL, device, row_tile, max_device_pixels):
    """The (nyL, nxL) bool exclusion mask of the shape-independent host
    layers (unbuffered rasters the device does not sample, and geometry
    layers) over the lattice, one tensor on the device: cached on the
    excluder, keyed by the device, the lattice and the layers.  Cold, it
    is built per row block on one worker thread, the next block queued
    while this one is uploaded through a ``PinnedRing`` and unpacked into
    its rows (one block with a callable code filter, which need not be
    pointwise)."""
    from atlite_tpu_torch.core.grid import Affine
    from atlite_tpu_torch.gis.exclusion import _native_code_mask, build_exclusion_mask

    def _codes_key(codes):
        if codes is None:
            return None
        if callable(codes):
            return ("fn", id(codes))
        return tuple(np.atleast_1d(codes).tolist())

    res = excluder.res
    cache_key = (
        str(device), tuple(tL), nyL, nxL,
        tuple((id(d["raster"]), _codes_key(d["codes"]), d["invert"], d["nodata"])
              for d in layers),
        tuple((id(d["geometry"]), d["buffer"], d["invert"]) for d in excluder.geometries),
    )
    cached = getattr(excluder, "_fine_mask_cache", None)
    if cached is not None and cached[0] == cache_key:
        return cached[1]
    for d in layers:
        if not callable(d["codes"]):
            _native_code_mask(d)  # primed before the view copies the layers, so they share it
    view = _BlockExcluder(excluder, rasters=layers)
    # geometry-layer dilation reaches across block edges: build with a
    # margin and crop
    margin = max([_dilation_iterations(d["buffer"], res)
                  for d in excluder.geometries if d["buffer"]] + [0])
    if any(callable(d["codes"]) for d in layers):
        row_block = nyL  # a callable need not be pointwise: one block
    else:
        row_block = max(row_tile, min(nyL, max_device_pixels // max(8 * nxL, 1)))
        row_block = -(-row_block // row_tile) * row_tile
    blocks = [(b0, min(b0 + row_block, nyL)) for b0 in range(0, nyL, row_block)]

    def _build(b0, b1):
        # a profiler range on the worker thread: the host's build ms of
        # each block, in a trace of the call
        with span("mask", b0, b1):
            m0, m1 = max(b0 - margin, 0), min(b1 + margin, nyL)
            sub_t = Affine(tL.a, 0.0, tL.c, 0.0, tL.e, tL.f + tL.e * m0)
            m = build_exclusion_mask(view, sub_t, (m1 - m0, nxL))
            return np.packbits(m[b0 - m0:b0 - m0 + (b1 - b0)])

    mask = torch.empty((nyL, nxL), dtype=torch.bool, device=device)
    ring = PinnedRing(device)
    with ThreadPoolExecutor(max_workers=1) as worker:
        fut = worker.submit(_build, *blocks[0])
        for k, (b0, b1) in enumerate(blocks):
            packed = fut.result()
            if k + 1 < len(blocks):
                fut = worker.submit(_build, *blocks[k + 1])
            host = ring.host(packed.size)
            host.numpy()[:] = packed
            blk = _unpack_mask_device(ring.copy(host), (b1 - b0) * nxL)
            mask[b0:b1] = blk.reshape(b1 - b0, nxL)
    excluder._fine_mask_cache = (cache_key, mask)
    return mask
