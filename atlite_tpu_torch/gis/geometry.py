"""Host-side geometry engine (a copy of ``atlite_tpu/gis/geometry.py``).

atlite leans on GEOS via shapely for polygon set operations, STRtree
queries and point-in-polygon tests (its gis.py:104-183, hydro.py:23-30).
This engine is numpy alone: polygons are plain (N, 2) float64 rings, and
the two operations the pipelines need are implemented directly:

- polygon ∩ axis-aligned box area by Sutherland–Hodgman clipping (grid
  cells are boxes: the indicator matrix only ever clips against boxes),
- even-odd point-in-polygon (the basin lookup, rasterization).

Candidate search uses the regular grid directly (a bbox maps to an index
range in O(1)) instead of an R-tree.  A C++ drop-in for the clipping hot
loop lives in ``atlite_tpu_torch/native`` (used when it builds).
"""

from __future__ import annotations

import numpy as np


# --------------------------------------------------------------------------
# geometry types
# --------------------------------------------------------------------------
class Geometry:
    geom_type = "Geometry"

    @property
    def bounds(self):
        # cached: the intersection-matrix cell loop queries bounds per
        # cell, and concatenating every ring each time cost O(vertices)
        # per call (geometries are immutable once built)
        b = getattr(self, "_bounds_cache", None)
        if b is None:
            pts = np.concatenate(self._all_coords())
            b = (pts[:, 0].min(), pts[:, 1].min(),
                 pts[:, 0].max(), pts[:, 1].max())
            self._bounds_cache = b
        return b

    @property
    def __geo_interface__(self):
        raise NotImplementedError


class Point(Geometry):
    geom_type = "Point"

    def __init__(self, x, y=None):
        if y is None:
            x, y = x
        self.x, self.y = float(x), float(y)

    def _all_coords(self):
        return [np.array([[self.x, self.y]])]

    @property
    def __geo_interface__(self):
        return {"type": "Point", "coordinates": (self.x, self.y)}


class LineString(Geometry):
    geom_type = "LineString"

    def __init__(self, coords):
        self.coords = np.asarray(coords, dtype=float).reshape(-1, 2)

    def _all_coords(self):
        return [self.coords]

    @property
    def __geo_interface__(self):
        return {"type": "LineString", "coordinates": [tuple(c) for c in self.coords]}


class Polygon(Geometry):
    geom_type = "Polygon"

    def __init__(self, shell, holes=()):
        shell = np.asarray(shell, dtype=float).reshape(-1, 2)
        # drop an explicit closing vertex; rings are implicitly closed.
        # EXACT comparison: GeoJSON closure repeats the first vertex
        # bit-identically, while an rtol test at projected-meter scale
        # (rtol*4.5e6 ~ 45 m) silently deleted genuinely distinct
        # vertices near the ring start
        if len(shell) > 1 and bool(np.all(shell[0] == shell[-1])):
            shell = shell[:-1]
        self.shell = shell
        self.holes = []
        for h in holes:
            h = np.asarray(h, dtype=float).reshape(-1, 2)
            if len(h) > 1 and bool(np.all(h[0] == h[-1])):
                h = h[:-1]
            self.holes.append(h)

    def _all_coords(self):
        return [self.shell, *self.holes]

    @property
    def area(self):
        return abs(ring_signed_area(self.shell)) - sum(
            abs(ring_signed_area(h)) for h in self.holes
        )

    @property
    def __geo_interface__(self):
        close = lambda r: [tuple(c) for c in np.vstack([r, r[:1]])]
        return {
            "type": "Polygon",
            "coordinates": [close(self.shell), *(close(h) for h in self.holes)],
        }

    def contains_point(self, x, y):
        if not point_in_ring(self.shell, x, y):
            return False
        return not any(point_in_ring(h, x, y) for h in self.holes)


class MultiPolygon(Geometry):
    geom_type = "MultiPolygon"

    def __init__(self, polygons):
        self.polygons = [p if isinstance(p, Polygon) else Polygon(*p) for p in polygons]

    def _all_coords(self):
        return [c for p in self.polygons for c in p._all_coords()]

    @property
    def area(self):
        return sum(p.area for p in self.polygons)

    @property
    def __geo_interface__(self):
        return {
            "type": "MultiPolygon",
            "coordinates": [p.__geo_interface__["coordinates"] for p in self.polygons],
        }

    def contains_point(self, x, y):
        return any(p.contains_point(x, y) for p in self.polygons)


def box(xmin, ymin, xmax, ymax):
    return Polygon([(xmin, ymin), (xmax, ymin), (xmax, ymax), (xmin, ymax)])


# --------------------------------------------------------------------------
# parsing / conversion
# --------------------------------------------------------------------------
def parse_geometry(obj) -> Geometry:
    """Coerce our types, __geo_interface__ objects (incl. shapely if present)
    or GeoJSON-style dicts into engine geometries."""
    if isinstance(obj, Geometry):
        return obj
    gi = getattr(obj, "__geo_interface__", obj if isinstance(obj, dict) else None)
    if gi is None:
        raise TypeError(f"cannot interpret {type(obj)} as geometry")
    t = gi["type"]
    if t == "Feature":
        return parse_geometry(gi["geometry"])
    if t in ("FeatureCollection", "GeometryCollection"):
        raise TypeError(
            f"{t} holds multiple geometries; pass them individually "
            "(e.g. iterate the features/geometries list)")
    if "coordinates" not in gi:
        raise TypeError(f"unsupported geometry type {t!r} (no coordinates)")
    c = gi["coordinates"]
    if t == "Point":
        return Point(*c)
    if t == "LineString":
        return LineString(c)
    if t == "Polygon":
        return Polygon(c[0], c[1:])
    if t == "MultiPolygon":
        return MultiPolygon([Polygon(p[0], p[1:]) for p in c])
    raise TypeError(f"unsupported geometry type {t}")


def transform_geometry(geom: Geometry, src, dst) -> Geometry:
    """Reproject a geometry vertex-wise (atlite gis.py:87-101)."""
    from atlite_tpu_torch.gis.crs import transform_points

    def tr(coords):
        x, y = transform_points(coords[:, 0], coords[:, 1], src, dst)
        return np.column_stack([x, y])

    if isinstance(geom, Point):
        c = tr(np.array([[geom.x, geom.y]]))
        return Point(c[0, 0], c[0, 1])
    if isinstance(geom, LineString):
        return LineString(tr(geom.coords))
    if isinstance(geom, Polygon):
        return Polygon(tr(geom.shell), [tr(h) for h in geom.holes])
    if isinstance(geom, MultiPolygon):
        return MultiPolygon([transform_geometry(p, src, dst) for p in geom.polygons])
    raise TypeError(type(geom))


# --------------------------------------------------------------------------
# core computational geometry
# --------------------------------------------------------------------------
def ring_signed_area(ring: np.ndarray) -> float:
    """Shoelace signed area of an implicitly closed ring."""
    if len(ring) < 3:
        return 0.0
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def clip_ring_box(ring: np.ndarray, xmin, ymin, xmax, ymax) -> np.ndarray:
    """Sutherland–Hodgman clip of a ring against an axis-aligned box."""
    def clip_edge(pts, axis, bound, keep_ge):
        if len(pts) == 0:
            return pts
        out = []
        n = len(pts)
        for i in range(n):
            cur, nxt = pts[i], pts[(i + 1) % n]
            cin = (cur[axis] >= bound) if keep_ge else (cur[axis] <= bound)
            nin = (nxt[axis] >= bound) if keep_ge else (nxt[axis] <= bound)
            if cin:
                out.append(cur)
            if cin != nin:
                t = (bound - cur[axis]) / (nxt[axis] - cur[axis])
                out.append(cur + t * (nxt - cur))
        return np.asarray(out).reshape(-1, 2)

    pts = np.asarray(ring, dtype=float)
    pts = clip_edge(pts, 0, xmin, True)
    pts = clip_edge(pts, 0, xmax, False)
    pts = clip_edge(pts, 1, ymin, True)
    pts = clip_edge(pts, 1, ymax, False)
    return pts


def polygon_box_area(geom, xmin, ymin, xmax, ymax) -> float:
    """Exact |polygon ∩ box| via per-ring clipping (holes subtract)."""
    polys = geom.polygons if isinstance(geom, MultiPolygon) else [geom]
    total = 0.0
    for p in polys:
        total += abs(ring_signed_area(clip_ring_box(p.shell, xmin, ymin, xmax, ymax)))
        for h in p.holes:
            total -= abs(ring_signed_area(clip_ring_box(h, xmin, ymin, xmax, ymax)))
    return max(total, 0.0)


def point_in_ring(ring: np.ndarray, x, y) -> bool:
    """Even-odd rule ray casting."""
    xs, ys = ring[:, 0], ring[:, 1]
    x1, y1 = xs, ys
    x2, y2 = np.roll(xs, -1), np.roll(ys, -1)
    crosses = ((y1 > y) != (y2 > y))
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x1 + (y - y1) / (y2 - y1) * (x2 - x1)
    return bool(np.sum(crosses & (x < xint)) % 2)


def segment_intersects_box(p0, p1, xmin, ymin, xmax, ymax) -> bool:
    """Liang–Barsky segment/box test."""
    x0, y0 = p0
    x1, y1 = p1
    dx, dy = x1 - x0, y1 - y0
    t0, t1 = 0.0, 1.0
    for p, q in (
        (-dx, x0 - xmin), (dx, xmax - x0), (-dy, y0 - ymin), (dy, ymax - y0),
    ):
        if p == 0:
            if q < 0:
                return False
        else:
            r = q / p
            if p < 0:
                t0 = max(t0, r)
            else:
                t1 = min(t1, r)
            if t0 > t1:
                return False
    return True


def geometry_intersects_box(geom, xmin, ymin, xmax, ymax) -> bool:
    """Boolean intersection test against a box (area or boundary contact)."""
    gxmin, gymin, gxmax, gymax = geom.bounds
    if gxmax < xmin or gxmin > xmax or gymax < ymin or gymin > ymax:
        return False
    if isinstance(geom, Point):
        return xmin <= geom.x <= xmax and ymin <= geom.y <= ymax
    if isinstance(geom, LineString):
        c = geom.coords
        if len(c) == 1:  # degenerate one-point line: point-in-box
            return bool(xmin <= c[0, 0] <= xmax and ymin <= c[0, 1] <= ymax)
        return any(
            segment_intersects_box(c[i], c[i + 1], xmin, ymin, xmax, ymax)
            for i in range(len(c) - 1)
        )
    if isinstance(geom, (Polygon, MultiPolygon)):
        if polygon_box_area(geom, xmin, ymin, xmax, ymax) > 0:
            return True
        # zero-area contact: box corner on boundary or shared edge
        polys = geom.polygons if isinstance(geom, MultiPolygon) else [geom]
        for p in polys:
            for r in (p.shell, *p.holes):  # hole edges touch too
                ring = np.vstack([r, r[:1]])
                for i in range(len(ring) - 1):
                    if segment_intersects_box(ring[i], ring[i + 1],
                                              xmin, ymin, xmax, ymax):
                        return True
        return False
    raise TypeError(type(geom))


def points_in_polygon(geom, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Vectorized even-odd point-in-polygon over flat coordinate arrays (the
    numpy version of the C++ engine's ``points_in_rings``).

    The (edges x points) broadcast is evaluated in bounded point batches:
    country-scale fine grids (10^7+ pixels) against 1000-edge rings would
    otherwise materialize 10^10-element intermediates."""
    xs = np.asarray(xs, dtype=float).ravel()
    ys = np.asarray(ys, dtype=float).ravel()
    inside = np.zeros(xs.shape, dtype=bool)
    polys = geom.polygons if isinstance(geom, MultiPolygon) else [geom]
    n_edges = max(
        (sum(len(r) for r in [p.shell] + list(p.holes)) for p in polys),
        default=1)
    batch = max(1, int(2e7 / max(n_edges, 1)))  # ~20M-element intermediates
    for i in range(0, len(xs), batch):
        sl = slice(i, i + batch)
        xb, yb = xs[sl], ys[sl]
        for p in polys:
            acc = _ring_crossings(p.shell, xb, yb)
            for h in p.holes:
                acc ^= _ring_crossings(h, xb, yb)
            inside[sl] |= acc
    return inside


def _ring_crossings(ring, xs, ys):
    x1 = ring[:, 0][:, None]
    y1 = ring[:, 1][:, None]
    x2 = np.roll(ring[:, 0], -1)[:, None]
    y2 = np.roll(ring[:, 1], -1)[:, None]
    cond = (y1 > ys[None, :]) != (y2 > ys[None, :])
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x1 + (ys[None, :] - y1) / (y2 - y1) * (x2 - x1)
    return (np.sum(cond & (xs[None, :] < xint), axis=0) % 2).astype(bool)
