"""Plain reference of the availability matrix: PyPSA-Eur's onwind land
eligibility as atlite computes it, written anew in plain torch (float64
unless another ``dtype`` is asked for), from the benchmark's own inputs.

For each region, in its own window of the 100 m lattice (its bounding box
in EPSG:3035):

1. the region's vertices taken from EPSG:4326 to EPSG:3035 by the
   ellipsoidal Lambert azimuthal equal-area forward formulas (Snyder 1987,
   pp. 187-188, GRS80, lat 52 N, lon 10 E, false easting 4,321,000 m and
   northing 3,210,000 m);
2. the pixel centres inside the region by even-odd crossings (a pixel is
   inside when an odd number of the region's edges cross its row to the
   right of its centre);
3. each raster sampled at the pixel centres (nearest), its nodata outside
   the raster and, for the cropped layers, outside the region (atlite's
   ``projected_mask`` with ``crop=True``); codes selected, inverted where
   the layer says so, and a buffered layer dilated ``int(buffer / res) + 1``
   times by the 4-connected cross (scipy's ``binary_dilation``);
4. the available pixels: inside and excluded by no layer;
5. every pixel centre mapped to its cutout cell by the inverse of the same
   projection (Snyder, p. 189, the latitude from q by Newton's iteration,
   p. 188) and the floor of its grid coordinates; a cell's share is its
   available pixels over all of its pixels (the mean of a centre-point
   resampling, the semantics of the port's cross-CRS path).

Departures from atlite, noted: atlite resamples by GDAL's area-weighted
average, not the mean over pixel centres; its window is the region's
bounds snapped outward to the lattice, which changes no pixel inside the
region; a layer with both ``invert`` and ``buffer`` would see this
window's edges (PyPSA-Eur's onwind excluder has none).  Unbuffered layers
are cropped too: outside the region it makes no difference.

The work goes region by region, the crossing tests in blocks of rows, so
that it fits a card whatever the lattice.  ``crop=False`` and
``iterations`` plant the two faults the benchmark's controls read.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# GRS80 and EPSG:3035's parameters
A = 6378137.0
F = 1.0 / 298.257222101
E2 = F * (2.0 - F)
E = math.sqrt(E2)
LAT0, LON0 = math.radians(52.0), math.radians(10.0)
FE, FN = 4321000.0, 3210000.0
BLOCK = 1 << 24  # elements of one block of crossing tests


def _q(sinphi):
    """Snyder's q (eq. 3-12)."""
    es = E * sinphi
    return (1.0 - E2) * (sinphi / (1.0 - es * es)
                         - 1.0 / (2.0 * E) * torch.log((1.0 - es) / (1.0 + es)))


def _constants(dtype, device):
    t = lambda v: torch.tensor(v, dtype=torch.float64, device=device)  # noqa: E731
    qp = _q(t(1.0))
    q1 = _q(t(math.sin(LAT0)))
    rq = A * torch.sqrt(qp / 2.0)
    beta1 = torch.asin(q1 / qp)
    m1 = math.cos(LAT0) / math.sqrt(1.0 - E2 * math.sin(LAT0) ** 2)
    d = A * m1 / (rq * torch.cos(beta1))
    return [v.to(dtype) for v in (qp, rq, beta1, d)]


def laea_forward(lon, lat, dtype=torch.float64):
    """EPSG:4326 degrees to EPSG:3035 metres (Snyder eqs. 24-11 to 24-18)."""
    lon, lat = torch.as_tensor(lon, dtype=dtype), torch.as_tensor(lat, dtype=dtype)
    qp, rq, beta1, d = _constants(dtype, lon.device)
    phi, lam = torch.deg2rad(lat), torch.deg2rad(lon) - LON0
    beta = torch.asin(_q(torch.sin(phi)) / qp)
    b = rq * torch.sqrt(2.0 / (1.0 + torch.sin(beta1) * torch.sin(beta)
                               + torch.cos(beta1) * torch.cos(beta) * torch.cos(lam)))
    x = b * d * torch.cos(beta) * torch.sin(lam)
    y = (b / d) * (torch.cos(beta1) * torch.sin(beta)
                   - torch.sin(beta1) * torch.cos(beta) * torch.cos(lam))
    return x + FE, y + FN


def laea_inverse(x, y):
    """EPSG:3035 metres to EPSG:4326 degrees (Snyder eqs. 24-28 to 24-30,
    the latitude by eq. 3-16 iterated)."""
    dtype = x.dtype
    qp, rq, beta1, d = _constants(dtype, x.device)
    x, y = x - FE, y - FN
    rho = torch.sqrt((x / d) ** 2 + (d * y) ** 2)
    c = 2.0 * torch.asin(torch.clamp(rho / (2.0 * rq), max=1.0))
    safe = torch.where(rho > 0, rho, torch.ones_like(rho))
    q = qp * (torch.cos(c) * torch.sin(beta1) + d * y * torch.sin(c) * torch.cos(beta1) / safe)
    lam = torch.atan2(x * torch.sin(c),
                      d * rho * torch.cos(beta1) * torch.cos(c) - d * d * y * torch.sin(beta1)
                      * torch.sin(c))
    phi = torch.asin(torch.clamp(q / 2.0, -1.0, 1.0))
    for _ in range(6):
        s = torch.sin(phi)
        es2 = 1.0 - E2 * s * s
        phi = phi + es2 * es2 / (2.0 * torch.cos(phi)) * (
            q / (1.0 - E2) - s / es2
            + 1.0 / (2.0 * E) * torch.log((1.0 - E * s) / (1.0 + E * s)))
    return torch.rad2deg(lam) + math.degrees(LON0), torch.rad2deg(phi)


def inside(ring, xs, ys):
    """(len(ys), len(xs)) bool: the centres (xs[j], ys[i]) inside the
    closed ring (V, 2), by even-odd crossings to their right."""
    x1, y1 = ring[:, 0], ring[:, 1]
    x2, y2 = torch.roll(x1, -1), torch.roll(y1, -1)
    out = torch.empty((ys.shape[0], xs.shape[0]), dtype=torch.bool, device=xs.device)
    rows = max(1, BLOCK // max(xs.shape[0] * ring.shape[0], 1))
    for r0 in range(0, ys.shape[0], rows):
        y = ys[r0:r0 + rows, None]
        crosses = (y1 > y) != (y2 > y)                       # (rows, V)
        dy = torch.where(crosses, y2 - y1, torch.ones_like(y1))
        at = x1 + (y - y1) * (x2 - x1) / dy                  # the edge's abscissa on the row
        right = crosses[:, None, :] & (xs[None, :, None] < at[:, None, :])
        out[r0:r0 + rows] = (right.sum(dim=2) % 2).bool()
    return out


def dilate(m, iterations):
    """4-connected dilation of a 2-D bool mask, nothing beyond its edges."""
    for _ in range(iterations):
        grown = m.clone()
        grown[1:] |= m[:-1]
        grown[:-1] |= m[1:]
        grown[:, 1:] |= m[:, :-1]
        grown[:, :-1] |= m[:, 1:]
        m = grown
    return m


def sample(raster, origin, res, xs, ys, nodata, dtype):
    """Nearest sampling of a (rows, cols) uint8 raster whose top-left
    corner is ``origin`` at the centres (xs, ys): (len(ys), len(xs))."""
    x0, y0 = origin
    col = torch.floor((xs - torch.tensor(x0, dtype=dtype, device=xs.device)) / res).long()
    row = torch.floor((torch.tensor(y0, dtype=dtype, device=xs.device) - ys) / res).long()
    h, w = raster.shape
    ok = ((row >= 0) & (row < h))[:, None] & ((col >= 0) & (col < w))[None, :]
    vals = raster[row.clamp(0, h - 1)[:, None], col.clamp(0, w - 1)[None, :]]
    return torch.where(ok, vals, torch.full_like(vals, nodata))


def cell_of(xs, ys, grid):
    """(len(ys), len(xs)) int64 cell of each pixel centre (ascending rows,
    x fastest), -1 outside the grid, by the inverse projection in float64
    unless the coordinates are of another type."""
    X, Y = torch.broadcast_tensors(xs[None, :], ys[:, None])
    lon, lat = laea_inverse(X, Y)
    ci = torch.floor((lon - grid["lon0"]) / grid["dx"]).long()
    ri = torch.floor((lat - grid["lat0"]) / grid["dy"]).long()
    ok = (ci >= 0) & (ci < grid["NX"]) & (ri >= 0) & (ri < grid["NY"])
    return torch.where(ok, ri * grid["NX"] + ci, torch.full_like(ci, -1))


def _window(xy, res, margin=0):
    """Integer lattice indices (kx0, kx1, ky0, ky1) of a box of points,
    the pixels whose centres can lie in it, and ``margin`` more."""
    kx0 = math.floor(float(xy[:, 0].min()) / res) - margin
    kx1 = math.ceil(float(xy[:, 0].max()) / res) + margin
    ky0 = math.floor(float(xy[:, 1].min()) / res) - margin
    ky1 = math.ceil(float(xy[:, 1].max()) / res) + margin
    return kx0, kx1, ky0, ky1


def matrix(inputs, config, dtype=torch.float64, device="cpu", crop=True, iterations=None):
    """(S, NY, NX) share of each cell available to each region, ascending
    latitude.  ``inputs``: ``shells`` (S, V, 2) lon/lat, ``corine`` and
    ``natura`` (rows, cols) uint8, ``origin`` (x, y) of their top-left
    corner in EPSG:3035, ``lon``/``lat`` the cutout's cell centres."""
    device = torch.device(device)
    exc = config["excluder"]
    res = float(exc["res"])
    lon_c, lat_c = np.asarray(inputs["lon"]), np.asarray(inputs["lat"])
    dx, dy = float(lon_c[1] - lon_c[0]), float(lat_c[1] - lat_c[0])
    grid = dict(lon0=float(lon_c[0]) - dx / 2, lat0=float(lat_c[0]) - dy / 2, dx=dx, dy=dy,
                NX=len(lon_c), NY=len(lat_c))
    ncell = grid["NX"] * grid["NY"]
    rasters = {n: torch.as_tensor(inputs[n], device=device) for n in ("corine", "natura")}
    origin = tuple(float(v) for v in inputs["origin"])
    shells = torch.as_tensor(np.asarray(inputs["shells"]), dtype=torch.float64, device=device)
    S = shells.shape[0]
    X, Y = laea_forward(shells[..., 0], shells[..., 1])
    rings = torch.stack([X, Y], dim=-1)
    num = torch.zeros((S, ncell), dtype=torch.float64, device=device)
    touched = torch.zeros(ncell, dtype=torch.bool, device=device)
    for s in range(S):
        kx0, kx1, ky0, ky1 = _window(rings[s], res)
        xs = ((torch.arange(kx0, kx1, device=device, dtype=torch.float64) + 0.5) * res).to(dtype)
        ys = ((torch.arange(ky0, ky1, device=device, dtype=torch.float64) + 0.5) * res).to(dtype)
        ins = inside(rings[s].to(dtype), xs, ys)
        excl = torch.zeros_like(ins)
        for layer in exc["layers"]:
            nodata = layer.get("nodata", 255)
            vals = sample(rasters[layer["raster"]], origin, res, xs, ys, nodata, dtype)
            if crop:
                vals = torch.where(ins, vals, torch.full_like(vals, nodata))
            codes = layer.get("codes")
            sel = vals != 0 if codes is None else torch.isin(
                vals, torch.as_tensor(codes, dtype=vals.dtype, device=device))
            if layer.get("invert"):
                sel = ~sel
            if layer.get("buffer"):
                n = int(layer["buffer"] / res) + 1 if iterations is None else iterations
                sel = dilate(sel, n)
            excl |= sel
        avail = ins & ~excl
        cells = cell_of(xs, ys, grid)
        hit = cells >= 0
        touched[cells[hit]] = True
        num[s] += torch.bincount(cells[hit & avail], minlength=ncell).to(torch.float64)
    cnt = _cell_counts(touched, grid, res, dtype, device)
    share = torch.where(cnt > 0, num / torch.where(cnt > 0, cnt, 1.0), 0.0)
    return share.reshape(S, grid["NY"], grid["NX"])


def _cell_counts(touched, grid, res, dtype, device):
    """(ncell,) float64 count of the lattice's pixel centres in each
    touched cell: every pixel of a box around those cells' corners (taken
    to EPSG:3035 along their edges) mapped to its cell."""
    ids = torch.nonzero(touched).flatten()
    ri, ci = ids // grid["NX"], ids % grid["NX"]
    t = torch.linspace(0.0, 1.0, 17, dtype=torch.float64, device=device)
    lon = grid["lon0"] + grid["dx"] * torch.cat([ci.min() + t * (ci.max() + 1 - ci.min()),
                                                 ci.min() + t * (ci.max() + 1 - ci.min()),
                                                 ci.min() + 0 * t, ci.max() + 1 + 0 * t])
    lat = grid["lat0"] + grid["dy"] * torch.cat([ri.min() + 0 * t, ri.max() + 1 + 0 * t,
                                                 ri.min() + t * (ri.max() + 1 - ri.min()),
                                                 ri.min() + t * (ri.max() + 1 - ri.min())])
    X, Y = laea_forward(lon, lat)
    kx0, kx1, ky0, ky1 = _window(torch.stack([X, Y], dim=-1), res, margin=2)
    xs = ((torch.arange(kx0, kx1, device=device, dtype=torch.float64) + 0.5) * res).to(dtype)
    ncell = grid["NX"] * grid["NY"]
    cnt = torch.zeros(ncell, dtype=torch.float64, device=device)
    rows = max(1, (1 << 23) // xs.shape[0])
    for y0 in range(ky0, ky1, rows):
        ys = ((torch.arange(y0, min(y0 + rows, ky1), device=device, dtype=torch.float64) + 0.5)
              * res).to(dtype)
        cells = cell_of(xs, ys, grid)
        cnt += torch.bincount(cells[cells >= 0], minlength=ncell).to(torch.float64)
    return cnt
