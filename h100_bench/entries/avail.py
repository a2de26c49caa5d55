"""The ``avail`` entry: PyPSA-Eur's land-eligibility step through the
port's ``Cutout.availabilitymatrix``.  Each call builds a fresh
``ExclusionContainer`` with the configuration's layers, as PyPSA-Eur does
for each technology, and asks for the (regions, y, x) availability
matrix of the configuration's regions over the cutout's grid, with the
traffic's ``call_kwargs`` (``backend="device"``: always the card's route);
the answer is the host array.

Inputs made from the seed: the regions, a random-walk partition of the
configuration's box in EPSG:4326, and a CORINE-like and a Natura-like
uint8 raster on the excluder's lattice in EPSG:3035, made in coherent
patches on the device and brought to the host.  The program's counter
``availability_matrix_device.window_pixels`` (where the program has it)
is kept a call for ``window_mpix``."""

from __future__ import annotations

import hashlib
import math
import time

import numpy as np
import torch

from h100_bench.harness import named
from h100_bench.harness.cutout import hours_of, lattice

# relative L2 gap of the (regions, y, x) matrix; set from the readings in
# PERF.md section 6: sound runs, the controls, and one region x 1.01 among
# the cell's 256
LIMIT = 2e-4


def seeded(seed, name):
    digest = hashlib.sha256(f"{int(seed)}:avail:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def reference_module(bench=named.BENCH):
    return named.module("reference", "availability", bench)


def _bridge(rng, n, length, bend, cone):
    """(n,) displacement across an edge of ``length``: a random walk pinned
    at both ends, kept within a cone of slope ``cone`` from each end so
    that edges meeting at a corner never cross, reaching ``bend`` x length
    to either side once (at 3/8 and 5/8 of the edge, in a seeded order),
    so that every region's box in degrees is the same whatever the
    seed."""
    steps = rng.standard_normal(n - 1)
    walk = np.concatenate([[0.0], np.cumsum(steps)])
    t = np.linspace(0.0, 1.0, n)
    walk -= t * walk[-1]
    reach = bend * length
    walk *= 0.9 * reach / max(np.abs(walk).max(), 1e-12)
    walk = np.clip(walk, -cone * length * np.minimum(t, 1.0 - t),
                   cone * length * np.minimum(t, 1.0 - t))
    a, b = (3 * (n - 1)) // 8, (5 * (n - 1)) // 8
    walk[a], walk[b] = (reach, -reach) if rng.random() < 0.5 else (-reach, reach)
    return walk


def regions(config, seed):
    """(ny * nx, 4 (n - 1), 2) lon/lat rings of the partition of the box
    into ny x nx regions, row by row from the south-west; each shared
    border one random-walk polyline of ``edge_vertices`` points."""
    r = config["regions"]
    x0, y0, x1, y1 = r["bounds"]
    ny, nx, n = r["ny"], r["nx"], r["edge_vertices"]
    gx, gy = np.linspace(x0, x1, nx + 1), np.linspace(y0, y1, ny + 1)
    rng = np.random.default_rng(seeded(seed, "regions"))
    t = np.linspace(0.0, 1.0, n)
    # horizontal borders h[j][i]: from (gx[i], gy[j]) to (gx[i+1], gy[j])
    h = [[np.column_stack([gx[i] + t * (gx[i + 1] - gx[i]),
                           gy[j] + _bridge(rng, n, gx[i + 1] - gx[i], r["bend"], r["cone"])])
          for i in range(nx)] for j in range(ny + 1)]
    # vertical borders v[j][i]: from (gx[i], gy[j]) to (gx[i], gy[j+1])
    v = [[np.column_stack([gx[i] + _bridge(rng, n, gy[j + 1] - gy[j], r["bend"], r["cone"]),
                           gy[j] + t * (gy[j + 1] - gy[j])])
          for i in range(nx + 1)] for j in range(ny)]
    rings = [np.concatenate([h[j][i][:-1], v[j][i + 1][:-1], h[j + 1][i][::-1][:-1],
                             v[j][i][::-1][:-1]])
             for j in range(ny) for i in range(nx)]
    return np.stack(rings)


def raster_lattice(config):
    """(origin (x, y) of the top-left corner, (rows, cols)) of the rasters:
    the box's EPSG:3035 bounds and the margin, on the excluder's lattice."""
    ref = reference_module()
    res = float(config["excluder"]["res"])
    x0, y0, x1, y1 = config["regions"]["bounds"]
    t = np.linspace(0.0, 1.0, 257)
    lon = np.concatenate([x0 + t * (x1 - x0), x0 + t * (x1 - x0), np.full_like(t, x0),
                          np.full_like(t, x1)])
    lat = np.concatenate([np.full_like(t, y0), np.full_like(t, y1), y0 + t * (y1 - y0),
                          y0 + t * (y1 - y0)])
    X, Y = (v.numpy() for v in ref.laea_forward(lon, lat))
    m = config["rasters"]["margin_m"]
    kx0, kx1 = math.floor((X.min() - m) / res), math.ceil((X.max() + m) / res)
    ky0, ky1 = math.floor((Y.min() - m) / res), math.ceil((Y.max() + m) / res)
    return (kx0 * res, ky1 * res), (ky1 - ky0, kx1 - kx0)


def _noise(shape, scale, gen, device):
    """(rows, cols) smooth noise in [0, 1]: uniform values every ``scale``
    pixels, bilinear between them."""
    h, w = shape[0] // scale + 2, shape[1] // scale + 2
    low = torch.rand((1, 1, h, w), generator=gen, device=device)
    up = torch.nn.functional.interpolate(low, size=((h - 1) * scale, (w - 1) * scale),
                                         mode="bilinear", align_corners=True)
    return up[0, 0, :shape[0], :shape[1]]


def _field(shape, scales_m, res, gen, device):
    """Noise of two scales (metres), weighted 0.7 and 0.3."""
    a, b = (_noise(shape, max(1, int(s / res)), gen, device) for s in scales_m)
    return 0.7 * a + 0.3 * b


def _quantiles(field, shares, gen):
    """Thresholds below which the given cumulative shares of ``field`` lie,
    from a seeded sample of a million pixels."""
    flat = field.reshape(-1)
    pick = torch.randint(0, flat.numel(), (1 << 20,), generator=gen, device=field.device)
    q = torch.as_tensor(shares, dtype=torch.float32, device=field.device)
    return torch.quantile(flat[pick], q)


def rasters(config, seed, device):
    """(corine, natura) uint8 rasters made on ``device`` from the seed."""
    res = float(config["excluder"]["res"])
    _, shape = raster_lattice(config)
    spec = config["rasters"]
    gen = torch.Generator(device=device).manual_seed(seeded(seed, "rasters"))
    cor = spec["corine"]
    urban = _field(shape, cor["urban"]["scales_m"], res, gen, device)
    is_urban = urban > _quantiles(urban, [1.0 - cor["urban"]["share"]], gen)[0]
    del urban
    pick = _noise(shape, max(1, int(1000 / res)), gen, device)
    codes = torch.as_tensor(cor["urban"]["codes"], dtype=torch.uint8, device=device)
    corine = codes[(pick * len(codes)).long().clamp(0, len(codes) - 1)]
    land = _field(shape, cor["scales_m"], res, gen, device)
    cum = np.cumsum([c["share"] for c in cor["classes"]])
    edges = _quantiles(land, list(cum[:-1] / cum[-1]), gen)
    group = torch.bucketize(land, edges)
    del land
    for k, c in enumerate(cor["classes"]):
        codes = torch.as_tensor(c["codes"], dtype=torch.uint8, device=device)
        sub = codes[(pick * len(codes)).long().clamp(0, len(codes) - 1)]
        corine = torch.where((group == k) & ~is_urban, sub, corine)
    del group, pick, is_urban
    nat = spec["natura"]
    field = _field(shape, nat["scales_m"], res, gen, device)
    natura = (field > _quantiles(field, [1.0 - nat["share"]], gen)[0]).to(torch.uint8)
    return corine.cpu().numpy(), natura.cpu().numpy()


def excluder(session):
    """A fresh ExclusionContainer with the configuration's layers."""
    from atlite_tpu_torch import ExclusionContainer

    exc = session.config["excluder"]
    out = ExclusionContainer(crs=exc["crs"], res=exc["res"])
    for layer in exc["layers"]:
        kw = {k: v for k, v in layer.items() if k != "raster"}
        out.add_raster(session.state["rasters"][layer["raster"]], **kw)
    return out


def bound_bytes(session):
    """The call's byte bound: each distinct raster read once over the
    lattice box of the regions (1 B a pixel), and the (S, NY, NX) float32
    matrix written once."""
    ref = reference_module(session.bench)
    res = float(session.config["excluder"]["res"])
    shells = session.inputs["shells"]
    X, Y = ref.laea_forward(shells[..., 0].ravel(), shells[..., 1].ravel())
    nx = math.ceil(float(X.max()) / res) - math.floor(float(X.min()) / res)
    ny = math.ceil(float(Y.max()) / res) - math.floor(float(Y.min()) / res)
    distinct = len({layer["raster"] for layer in session.config["excluder"]["layers"]})
    return distinct * nx * ny + 4 * len(shells) * len(session.y) * len(session.x)


def build(session):
    from atlite_tpu_torch import Cutout
    from atlite_tpu_torch.core.grid import Affine, Grid
    from atlite_tpu_torch.gis.geometry import Polygon
    from atlite_tpu_torch.gis.raster import Raster

    config, dev = session.config, session.device
    c = config["cutout"]
    session.x = lattice(*c["x"], c["dx"], 180)
    session.y = lattice(*c["y"], c["dy"], 90)
    t0 = time.perf_counter()
    shells = regions(config, session.seed)
    corine, natura = rasters(config, session.seed, dev)
    origin, _ = raster_lattice(config)
    session.inputs = {"shells": shells, "corine": corine, "natura": natura,
                      "origin": origin, "lon": session.x, "lat": session.y}
    if dev.type == "cuda":
        # the peak that device_peak_gb reads starts here: the program's
        # calls, not the rasters made above
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    res = float(config["excluder"]["res"])
    transform = Affine(res, 0.0, origin[0], 0.0, -res, origin[1])
    crs = config["excluder"]["crs"]
    session.state = {
        "rasters": {"corine": Raster(corine, transform, crs, 255),
                    "natura": Raster(natura, transform, crs, 0)},
        "cutout": Cutout(data={}, grid_desc=Grid(x=session.x, y=session.y,
                                                 time=hours_of(c["time"]), crs=c["crs"]),
                         attrs={"module": c["module"], "dx": c["dx"], "dy": c["dy"], "dt": "h",
                                "prepared_features": []},
                         device=dev),
    }
    r = config["regions"]
    names = [f"{config['countries'][0]}{j:02d}{i:02d}" for j in range(r["ny"])
             for i in range(r["nx"])]
    shapes = {n: Polygon([tuple(p) for p in ring]) for n, ring in zip(names, shells)}
    session.phases.update(inputs=t1 - t0, cutout=time.perf_counter() - t1)
    kwargs = dict(session.traffic.get("call_kwargs", {}))
    cut = session.state["cutout"]

    def window_pixels():
        from atlite_tpu_torch.gis import kernels

        return getattr(kernels.availability_matrix_device, "window_pixels", None)

    def call():
        before = window_pixels()
        out = cut.availabilitymatrix(shapes, excluder(session), **kwargs).values
        after = window_pixels()
        meta = session.meta["avail"]
        if before is not None and after is not None:
            meta["window_pixels"] = meta.get("window_pixels", 0) + after - before
            meta["counted"] = meta.get("counted", 0) + 1
        return out

    session.add("avail", call, {"S": len(shells), "NY": len(session.y), "NX": len(session.x),
                                "bound_bytes": bound_bytes(session)})


def reference(session, label, dtype, device, **faults):
    """[(S, NY, NX)] availability of the regions in ``dtype``."""
    ref = reference_module(session.bench)
    return [ref.matrix(session.inputs, session.config, dtype, device, **faults)]


def answers(answer):
    """A call's (S, NY, NX) host array."""
    return [np.asarray(answer)]


def limit(session, label):
    return LIMIT
