"""Land-eligibility (exclusion) analysis (counterpart of
``atlite_tpu/gis/exclusion.py``).

atlite's semantics (its gis.py:263-762): an ExclusionContainer of raster
and geometry exclusion layers, fine-grid availability rasterization per
shape, and the availability matrix aggregated onto the cutout grid.

Pipeline per shape (atlite's shape_availability, gis.py:263-325):
  1. rasterize the shape on its padded fine grid (res, excluder.crs),
  2. per raster layer: resample onto that grid (nearest), apply code
     filters / inversion / buffer dilation, OR into the exclusion mask,
  3. per geometry layer: rasterize and OR,
  4. availability = shape mask minus exclusions,
  5. average-downsample onto the (top-down) cutout raster and flip
     (gis.py:328-373, 707-716).

The numpy implementation here is the semantics reference (the host
path); the batched device path (the shapes' windows worked in batches,
downsampled on the card) is ``gis.kernels``, which
``compute_availabilitymatrix`` takes on a cutout on a CUDA card.  Shapes
come as a list, a dict, or a pandas-like Series (its ``values`` and
``index``, read duck-typed: the port imports no pandas).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.gis import geometry as G
from atlite_tpu_torch.gis.crs import normalize_crs, transform_points
from atlite_tpu_torch.gis.raster import (
    Raster,
    binary_dilation,
    geometry_mask,
    pad_extent,
    padded_transform_and_shape,
    reproject_average,
    reproject_nearest,
)

logger = logging.getLogger(__name__)


class ExclusionContainer:
    """Container for exclusion rasters and geometries (atlite gis.py:376-532)."""

    def __init__(self, crs=3035, res=100):
        self.rasters = []
        self.geometries = []
        self.crs = normalize_crs(crs)
        self.res = res

    def add_raster(self, raster, codes=None, buffer=0, invert=False, nodata=255,
                   allow_no_overlap=False, crs=None):
        self.rasters.append(dict(
            raster=raster, codes=codes, buffer=buffer, invert=invert,
            nodata=nodata, allow_no_overlap=allow_no_overlap, crs=crs,
        ))

    def add_geometry(self, geometry, buffer=0, invert=False, crs=None):
        """Add vector exclusion geometry.  ``crs`` names the geometry's
        own CRS; atlite reprojects GeoSeries to the excluder CRS at open
        time (its gis.py:500-505) — without this, lon/lat polygons
        added to a metric excluder would rasterize as meter coordinates
        near the false origin and silently exclude nothing.  A pandas
        Series/GeoSeries-style input with a ``crs`` attribute is honored
        when ``crs`` is not given; plain geometries default to the
        excluder's CRS (current coordinates taken as already projected)."""
        if crs is None:
            crs = getattr(geometry, "crs", None)
        self.geometries.append(dict(geometry=geometry, buffer=buffer,
                                    invert=invert, crs=crs))

    def open_files(self):
        """Materialize raster files and parse geometries (atlite gis.py:470-506)."""
        for d in self.rasters:
            r = d["raster"]
            if isinstance(r, (str, Path)):
                r = Raster.open(r)
            if isinstance(r, np.ndarray):
                raise TypeError("raw arrays need a transform; pass a Raster")
            if d["crs"] is not None:
                # per-layer override: relabel a COPY — the caller's Raster
                # may be shared between layers (or still in caller hands)
                import dataclasses

                r = dataclasses.replace(r, crs=normalize_crs(d["crs"]))
            d["raster"] = r
        for d in self.geometries:
            geoms = d["geometry"]
            if not isinstance(geoms, (list, tuple)):
                try:
                    geoms = list(geoms)
                except TypeError:
                    geoms = [geoms]
            parsed = [G.parse_geometry(g) for g in geoms]
            gcrs = d.get("crs")
            if gcrs is not None and normalize_crs(gcrs) != self.crs:
                parsed = [G.transform_geometry(g, gcrs, self.crs)
                          for g in parsed]
            d["geometry"] = parsed
            d["crs"] = None  # applied; a re-open must not transform twice

    @property
    def all_open(self):
        return all(isinstance(d["raster"], Raster) for d in self.rasters) and all(
            isinstance(d["geometry"], list) and d.get("crs") is None
            for d in self.geometries
        )

    @property
    def all_closed(self):
        return all(isinstance(d["raster"], (str, Path)) for d in self.rasters) and all(
            isinstance(d["geometry"], (str, Path)) for d in self.geometries
        )

    def compute_shape_availability(self, geometry, dst_transform=None, dst_crs=None,
                                   dst_shape=None, geometry_crs=4326):
        dst_args = [dst_transform, dst_crs, dst_shape]
        if any(a is not None for a in dst_args):
            if not all(a is not None for a in dst_args):
                raise ValueError(
                    "Arguments dst_transform, dst_crs, dst_shape should be "
                    "all None or all defined."
                )
            return shape_availability_reprojected(
                geometry, self, dst_transform, dst_crs, dst_shape, geometry_crs
            )
        return shape_availability(geometry, self, geometry_crs)

    def plot_shape_availability(self, geometry, ax=None, set_title=True,
                                dst_transform=None, dst_crs=None,
                                dst_shape=None, show_kwargs=None,
                                plot_kwargs=None, geometry_crs=4326):
        """Plot the eligible area for one or more geometries
        (atlite gis.py:585-658); matplotlib is imported here only."""
        import matplotlib.pyplot as plt

        masked, transform = self.compute_shape_availability(
            geometry, dst_transform, dst_crs, dst_shape, geometry_crs
        )
        if ax is None:
            ax = plt.gca()
        rows, cols = masked.shape
        x0, y0 = transform * (0, rows)
        x1, y1 = transform * (cols, 0)
        show_kwargs = {"cmap": "Greens", **(show_kwargs or {})}
        ax.imshow(masked, extent=(x0, x1, y0, y1), origin="upper",
                  **show_kwargs)
        geoms = _as_geometry_list(geometry, geometry_crs, self.crs)
        for g in geoms:
            from atlite_tpu_torch.gis import geometry as GG

            polys = g.polygons if isinstance(g, GG.MultiPolygon) else [g]
            for p in polys:
                ring = np.vstack([p.shell, p.shell[:1]])
                ax.plot(ring[:, 0], ring[:, 1],
                        color=(plot_kwargs or {}).get("edgecolor", "k"))
        if set_title:
            share = masked.sum() * self.res**2 / sum(
                gg.area for gg in geoms
            )
            ax.set_title(f"Eligible area (green) {share:.2%}")
        return ax

    def __repr__(self):
        return (
            f"Exclusion Container"
            f"\n registered rasters: {len(self.rasters)} "
            f"\n registered geometry collections: {len(self.geometries)}"
            f"\n CRS: {self.crs} - Resolution: {self.res}"
        )


def _bounds_overlap(raster, window_bounds, window_crs):
    """Do the raster's bounds (in its own CRS) intersect the fine window?"""
    from atlite_tpu_torch.gis.crs import normalize_crs as _n

    rxmin, rymin, rxmax, rymax = raster.bounds
    if _n(raster.crs) != _n(window_crs):
        # sample the bounds BOUNDARY densely, not just the corners:
        # under a curved CRS an edge's extremum lies mid-edge and
        # corner-only bounds can miss genuine overlap (same pitfall
        # gis/kernels.py avoids for the fine-lattice cover)
        es = np.linspace(rxmin, rxmax, 33)
        ns = np.linspace(rymin, rymax, 33)
        xs = np.concatenate([es, es, np.full(33, rxmin), np.full(33, rxmax)])
        ys = np.concatenate([np.full(33, rymin), np.full(33, rymax), ns, ns])
        tx, ty = transform_points(xs, ys, raster.crs, window_crs)
        rxmin, rxmax = np.nanmin(tx), np.nanmax(tx)
        rymin, rymax = np.nanmin(ty), np.nanmax(ty)
    wxmin, wymin, wxmax, wymax = window_bounds
    return not (rxmax < wxmin or rxmin > wxmax or rymax < wymin or rymin > wymax)


def _as_geometry_list(geometry, src_crs, dst_crs):
    if (isinstance(geometry, (G.Geometry,))
            or hasattr(geometry, "__geo_interface__")
            or (isinstance(geometry, dict) and "type" in geometry)):
        geometry = [geometry]  # single geometry (incl. GeoJSON dicts)
    elif isinstance(geometry, dict):
        geometry = list(geometry.values())  # name -> geometry mapping
    elif hasattr(geometry, "values") and not isinstance(geometry, (list, tuple)):
        geometry = list(geometry.values)  # pandas Series / GeoSeries
    geoms = [G.parse_geometry(g) for g in geometry]
    if normalize_crs(src_crs) != normalize_crs(dst_crs):
        geoms = [G.transform_geometry(g, src_crs, dst_crs) for g in geoms]
    return geoms


def _total_bounds(geoms):
    b = np.array([g.bounds for g in geoms])
    return (b[:, 0].min(), b[:, 1].min(), b[:, 2].max(), b[:, 3].max())


def _code_select(values, codes):
    """Pointwise code-membership test.  Narrow integer rasters go through
    a 256/65536-entry lookup table, several times faster than np.isin at
    the tens of Mpix of the availability mask build."""
    if codes is None:
        return values.astype(bool)
    codes_arr = np.atleast_1d(np.asarray(codes))
    if (values.dtype.kind in "ui" and values.dtype.itemsize <= 2
            and codes_arr.dtype.kind in "ui"):
        n = 1 << (8 * values.dtype.itemsize)
        info = np.iinfo(values.dtype)
        cc = codes_arr[(codes_arr >= info.min)
                       & (codes_arr <= info.max)].astype(np.int64)
        table = np.zeros(n, dtype=bool)
        table[cc % n] = True  # signed dtypes fancy-index from the end
        return table[values]
    return np.isin(values, codes_arr)


def _nodata_selected(d):
    """Whether the layer's code test selects its nodata value (the value
    out-of-extent samples take), evaluated in the raster's own dtype so
    signed/unsigned wrapping matches the in-extent test."""
    vals_dtype = np.asarray(d["raster"].data).dtype
    return bool(_code_select(
        np.array([d["nodata"]], dtype=vals_dtype), d["codes"])[0])


def _native_code_mask(d):
    """The layer's code mask evaluated ONCE on the raster's NATIVE grid
    (code masks are shape- and lattice-independent).
    Nearest sampling commutes with any pointwise test, so downstream
    lattices sample this cached bool raster instead of re-running the
    code selection per call.  Callable codes are not precomputed (the
    contract hands them the projected array; a non-pointwise callable
    would not commute).  Returns (bool Raster, nodata_selected)."""
    codes = d["codes"]
    ckey = None if codes is None else tuple(np.atleast_1d(codes).tolist())
    key = (id(d["raster"]), ckey, d["nodata"])  # in-place layer mutation
    cached = d.get("_native_mask")
    if cached is None or cached[0] != key:
        r = d["raster"]
        sel = _code_select(np.asarray(r.data), codes)
        nod = _nodata_selected(d)
        cached = d["_native_mask"] = (
            key, Raster(sel, r.transform, r.crs, nod), nod)
    return cached[1], cached[2]


def build_exclusion_mask(excluder, transform, shape, crop_geoms=None):
    """OR of every exclusion layer (rasters, then geometries) of
    ``excluder`` rasterized on the ``shape`` lattice at ``transform`` in
    the excluder's CRS.  The ONE implementation of the per-layer
    codes/invert/buffer semantics — shared by the host path
    (shape_availability) and the device path
    (gis/kernels.availability_matrix_device), so the backends cannot
    drift (atlite's semantics, gis.py:296-323).

    ``crop_geoms`` reproduces atlite's per-query crop
    (projected_mask with crop=True, its gis.py:197-230): raster values
    OUTSIDE the query geometry become nodata BEFORE code selection and
    dilation, so out-of-shape pixels never act as buffer sources.  Only
    buffered layers can tell the difference inside the shape; the device
    path (gis/kernels.py) crops them in each shape's window."""
    if not excluder.all_open:
        excluder.open_files()
    exclusions = np.zeros(shape, dtype=bool)
    window_bounds = (
        transform.c, transform.f + transform.e * shape[0],
        transform.c + transform.a * shape[1], transform.f,
    )
    crop_inside = None
    if crop_geoms is not None:
        crop_inside = geometry_mask(crop_geoms, shape, transform,
                                    invert=True)
    for d in excluder.rasters:
        r = d["raster"]
        overlap = _bounds_overlap(r, window_bounds, excluder.crs)
        if not overlap and not d["allow_no_overlap"]:
            raise ValueError(
                "Raster and geometry do not overlap; pass "
                "allow_no_overlap=True to allow this."
            )
        if crop_geoms is None and not callable(d["codes"]):
            # fast lane: sample the cached NATIVE bool code mask (the
            # pointwise code test commutes with nearest sampling) —
            # skips the per-lattice isin pass of the cold path
            if not overlap:
                # the scalar nodata outcome is all that matters; do not
                # build a full-raster mask for a window it never touches
                sel = np.full(shape, _nodata_selected(d), dtype=bool)
            else:
                mask_r, nod = _native_code_mask(d)
                sel = reproject_nearest(mask_r, transform, excluder.crs,
                                        shape, nodata=nod)
        else:
            if not overlap:
                masked_r = np.full(shape, d["nodata"])
            else:
                masked_r = reproject_nearest(r, transform, excluder.crs,
                                             shape, nodata=d["nodata"])
            if crop_inside is not None:
                masked_r = np.where(crop_inside, masked_r, d["nodata"])
            if d["codes"] is not None:
                if callable(d["codes"]):
                    sel = np.asarray(d["codes"](masked_r)).astype(bool)
                else:
                    sel = _code_select(masked_r, d["codes"])
            else:
                sel = masked_r.astype(bool)
        if d["invert"]:
            sel = ~sel
        if d["buffer"]:
            iterations = int(d["buffer"] / excluder.res) + 1
            sel = binary_dilation(sel, iterations=iterations)
        exclusions |= sel

    for d in excluder.geometries:
        # atlite: exclusions |= ~geometry_mask(geom, invert=d["invert"])
        # (gis.py:321-323); the geometry buffer (gis.py:503-505, applied by
        # GEOS on the vector side there) is realized here as mask dilation
        # of the rasterized interior at fine-grid resolution.
        if d["invert"]:
            # outside-is-excluded needs the full window
            inside = geometry_mask(d["geometry"], shape, transform,
                                   invert=True)
            if d["buffer"]:
                iterations = int(d["buffer"] / excluder.res) + 1
                inside = binary_dilation(inside, iterations=iterations)
            exclusions |= ~inside
            continue
        # window the PIP rasterization to the layer's bbox (+buffer
        # margin): a small protected area on a country-scale lattice
        # otherwise pays O(all pixels x edges)
        if not d["geometry"]:
            continue  # empty layer is a no-op (nothing to exclude)
        margin = (int(d["buffer"] / excluder.res) + 2) if d["buffer"] else 1
        gx0, gy0, gx1, gy1 = _total_bounds(d["geometry"])
        c0 = int(np.floor((gx0 - transform.c) / transform.a)) - margin
        c1 = int(np.ceil((gx1 - transform.c) / transform.a)) + margin
        r0 = int(np.floor((gy1 - transform.f) / transform.e)) - margin
        r1 = int(np.ceil((gy0 - transform.f) / transform.e)) + margin
        c0, c1 = max(c0, 0), min(c1, shape[1])
        r0, r1 = max(r0, 0), min(r1, shape[0])
        if r0 >= r1 or c0 >= c1:
            continue  # layer entirely outside the window
        from atlite_tpu_torch.core.grid import Affine

        sub_t = Affine(transform.a, transform.b,
                       transform.c + transform.a * c0,
                       transform.d, transform.e,
                       transform.f + transform.e * r0)
        inside = geometry_mask(d["geometry"], (r1 - r0, c1 - c0), sub_t,
                               invert=True)
        if d["buffer"]:
            iterations = int(d["buffer"] / excluder.res) + 1
            inside = binary_dilation(inside, iterations=iterations)
        exclusions[r0:r1, c0:c1] |= inside
    return exclusions


def shape_availability(geometry, excluder, geometry_crs=None):
    """Eligible cells within geometry on the excluder's fine grid
    (atlite gis.py:263-325).  Returns (bool availability, Affine transform)."""
    if not excluder.all_open:
        excluder.open_files()
    geometry_crs = excluder.crs if geometry_crs is None else geometry_crs
    geoms = _as_geometry_list(geometry, geometry_crs, excluder.crs)

    transform, shape = padded_transform_and_shape(_total_bounds(geoms), excluder.res)
    masked = geometry_mask(geoms, shape, transform)  # True OUTSIDE the shape
    exclusions = masked | build_exclusion_mask(excluder, transform, shape,
                                               crop_geoms=geoms)
    return ~exclusions, transform


def shape_availability_reprojected(geometry, excluder, dst_transform, dst_crs,
                                   dst_shape, geometry_crs=None):
    """Fine availability mask average-downsampled onto the target raster
    (atlite gis.py:328-373).  Returns (float availability share, dst transform)."""
    masked, transform = shape_availability(geometry, excluder, geometry_crs)
    masked, transform = pad_extent(masked, transform, dst_transform,
                                   excluder.crs, dst_crs)
    src = Raster(masked.astype(np.uint8), transform, excluder.crs, nodata=None)
    out = reproject_average(src, dst_transform, dst_crs, dst_shape, nodata=0.0)
    return np.nan_to_num(out, nan=0.0), dst_transform


def _shapes_and_index(shapes):
    """(geometries, row labels) of a list, a dict or a pandas-like Series,
    as the JAX package reads them: a Series' ``values`` and ``index``, a
    dict's values and keys, else the items and 0..n-1."""
    if isinstance(shapes, dict):
        return list(shapes.values()), np.asarray(list(shapes))
    if hasattr(shapes, "index") and hasattr(shapes, "values") \
            and not isinstance(shapes, (list, tuple)):
        return list(shapes.values), shapes.index
    geoms = list(shapes)
    return geoms, np.arange(len(geoms))


def compute_availabilitymatrix(cutout, shapes, excluder, nprocesses=None,
                               disable_progressbar=True, shapes_crs=4326,
                               backend="auto", mesh=None):
    """Eligible share of each cutout cell per shape (atlite gis.py:674-762).

    Returns a DataArray (shape, y, x) of host values, ascending y; rows
    follow the shapes' index.  ``nprocesses`` and ``disable_progressbar``
    are accepted for atlite's signature; the computation is vectorized and
    runs in-process.  ``backend="device"`` runs the batched path of
    ``gis.kernels.availability_matrix_device`` on the cutout's device (a
    CUDA card, or the CPU); ``"host"`` the exact numpy path shape by
    shape.  The default ``"auto"`` takes the device path on a cutout on a
    CUDA card and the host path on a CPU cutout.  Where the device path
    cannot express the excluder (a CRS with no closed form), ``"auto"``
    takes the host path and logs so, while an explicit ``"device"`` raises
    ``NotImplementedError``.  ``mesh`` (port
    only; the JAX package takes it on ``availability_matrix_device``)
    splits the shapes of the device path over a ``core.mesh.Mesh``; with
    a mesh, "auto" takes the device path.
    """
    auto_backend = backend == "auto"
    if auto_backend:
        backend = "device" if cutout.device.type == "cuda" or mesh is not None else "host"
    geom_list, index = _shapes_and_index(shapes)

    if backend == "device":
        from atlite_tpu_torch.gis.kernels import availability_matrix_device

        try:
            availability = availability_matrix_device(
                cutout, geom_list, excluder, shapes_crs=shapes_crs, mesh=mesh
            )
        except NotImplementedError as exc:
            if not auto_backend:
                raise
            logger.info("availability matrix on the host path: %s", exc)
            backend = "host"
    if backend == "host":
        availability = []
        for geom in geom_list:
            avail, _ = shape_availability_reprojected(
                [geom], excluder, cutout.grid_desc.transform_r, cutout.crs,
                cutout.shape, geometry_crs=shapes_crs,
            )
            availability.append(avail)
        # the fine mask was computed on the top-down raster; flip to the
        # ascending-y cutout order (atlite gis.py:707-716, 758)
        availability = np.stack(availability)[:, ::-1]
    elif backend != "device":
        raise ValueError(f"unknown backend {backend!r}")
    return DataArray(
        availability,
        coords={"shape": index, "y": cutout.grid_desc.y, "x": cutout.grid_desc.x},
        dims=("shape", "y", "x"),
    )
