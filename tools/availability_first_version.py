"""Time the availability device path (``atlite_tpu_torch/gis/kernels.py``)
against its first version on one CUDA card, in turns in one process:

- "first": per-shape pixel masks by an int32 prefix sum, counted per cell
  by ``index_add_`` of every pixel-shape and a ``bincount`` of the pixels,
  blocks of S x rows x nx <= max_device_pixels (as the JAX package sizes
  them);
- "runs, small blocks": the committed contraction (counts of runs of one
  cell from the sorted crossings, no per-shape mask) on the same blocks;
- "runs": the committed path as it is (cross-CRS blocks of
  max_device_pixels / PIXEL_BYTES pixels).

Cases: phase 15's (c) of chip_smoke.py (40 boxes over the continental
cut, 100 m EPSG:3035, ~816 Mpix) and a same-CRS lattice at 0.001 deg (12
boxes over 33 Mpix), where "first" differs from "runs" by its rasterization
only.  Each variant's availability must equal the committed path's
within 2e-6 (the same CRS's products sum in other blocks).  Prints wall s in turns and, per variant, the device busy ms,
idle share and time by kernel of one call (torch.profiler).

    PYTHONPATH=. python tools/availability_first_version.py
"""

import time

import numpy as np
import torch
from torch.autograd import DeviceType

import chip_smoke as cs
from atlite_tpu_torch.gis import kernels as TK

NOW = (TK._rasterize, TK._block_cells_crosscrs, TK.PIXEL_BYTES)


def first_rasterize(edges, edge_mask, px, py, row_tile):
    S, E = edge_mask.shape
    ny, nx = py.shape[0], px.shape[0]
    out = torch.empty((S, ny, nx), dtype=torch.bool, device=px.device)
    tile = min(max(ny, 1), max(row_tile, TK._TILE_ELEMS // max(S * E, 1)))
    for r0 in range(0, ny, tile):
        yb = py[r0:r0 + tile]
        j = torch.searchsorted(px, TK._crossings(edges, edge_mask, yb))
        hist = torch.zeros((S, yb.shape[0], nx + 1), dtype=torch.int32, device=px.device)
        hist.scatter_add_(2, j, torch.ones_like(j, dtype=torch.int32))
        below = torch.cumsum(hist[..., :nx], dim=2, dtype=torch.int32)
        odd = (below & 1).bool()
        out[:, r0:r0 + tile] = ~odd if E % 2 else odd
    return out


def first_cross(edges, emask, px, py_blk, excl_blk, inv_affine, ri0, *, src_crs, dst_crs, NX,
                NY, bins):
    fine = TK._block_masks(edges, emask, px, py_blk, excl_blk)
    S = fine.shape[0]
    lid, dropped = TK._cell_ids(px, py_blk, inv_affine, ri0, src_crs=src_crs, dst_crs=dst_crs,
                                NX=NX, NY=NY, bins=bins)
    lid = lid.reshape(-1)
    num = torch.zeros((S, bins), dtype=torch.int32, device=fine.device)
    num.index_add_(1, lid, fine.reshape(S, -1).to(torch.int32))
    return num.to(torch.int64), torch.bincount(lid, minlength=bins), dropped


def use(variant, S):
    TK._rasterize, TK._block_cells_crosscrs, TK.PIXEL_BYTES = {
        "first": (first_rasterize, first_cross, S),
        "runs, small blocks": (NOW[0], NOW[1], S),
        "runs": NOW,
    }[variant]


def compare(name, cutout, shapes, exc):
    """Warm calls of each variant in turns, then one of each under the
    profiler; the mask of ``exc`` is built by a first call (the variants
    with other blocks slice it)."""
    use("runs", len(shapes))
    base = cutout.availabilitymatrix(shapes, exc).values
    variants = ["first", "runs, small blocks", "runs"]
    times = {v: [] for v in variants}
    for v in variants + variants[::-1]:
        use(v, len(shapes))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cutout.availabilitymatrix(shapes, exc).values
        times[v].append(round(time.perf_counter() - t0, 4))
        diff = float(np.abs(out - base).max())
        if diff > 2e-6:
            raise RuntimeError(f"{name}, {v}: {diff} from the committed path")
    print(f"{name}: warm s in turns {times}", flush=True)
    for v in variants:
        use(v, len(shapes))
        torch.cuda.synchronize()
        with cs.profiled() as prof:
            t0 = time.perf_counter()
            cutout.availabilitymatrix(shapes, exc)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = cs.device_idle(prof, wall * 1e3)
        print(f"{name}, {v}: {wall:.4f} s under the profiler, busy ms and idle share {busy}",
              flush=True)
        ks = sorted(((cs.kernel_name(e.key), e.device_time_total / 1e3)
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
                    key=lambda kv: -kv[1])
        for kname, ms in ks[:8]:
            print(f"   {ms:9.2f} ms  {kname}", flush=True)
    use("runs", len(shapes))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip(), flush=True)
    cut = cs.Cutout(module="synthetic", x=slice(-12, 18 + cs.CONT_DX / 2),
                    y=slice(35, 60 + cs.CONT_DY / 2), dx=cs.CONT_DX, dy=cs.CONT_DY,
                    time="2013-01-01")
    cx0, cx1, cy0, cy1 = cs.CONT_EXTENT
    raster = cs.landuse_3035([cx0, cx0, cx1, cx1, (cx0 + cx1) / 2], [cy0, cy1, cy0, cy1, cy1],
                             cs.AVAIL_RES_M)
    sx, sy = np.linspace(cx0 + 0.5, cx1 - 3.5, 8), np.linspace(cy0 + 0.5, cy1 - 3.5, 5)
    shapes = [cs.box(x, y, x + 3.0, y + 3.0) for y in sy for x in sx]
    compare("(c) continental", cut, shapes, cs.excluder_of(raster, 3035, cs.AVAIL_RES_M)())
    del raster
    small = cs.Cutout(module="synthetic", bounds=cs.AVAIL_BOUNDS, time="2013-01-01")
    boxes = [cs.box(x, y, x + 1.2, y + 1.3) for x in np.linspace(-4, 0.5, 5)[:4]
             for y in np.linspace(56, 61, 4)[:3]]
    fine = cs.Raster(np.random.default_rng(0).integers(1, 6, (6400, 5800), dtype=np.uint8),
                     cs.Affine(0.001, 0, -4.2, 0, -0.001, 62.3), 4326, 255)
    compare("same CRS 0.001 deg", small, boxes, cs.excluder_of(fine, 4326, 0.001)())


if __name__ == "__main__":
    main()
