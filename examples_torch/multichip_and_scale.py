"""Scaling on the port: a cutout sharded over a ("t", "x") mesh of
devices, availability on the device path, and the banded aggregation of
a large matrix over the mesh.

The counterpart of examples/multichip_and_scale.py.  The mesh is eight
positions over the visible cards, repeated (one card eight times on a
one-card machine: the split is exercised, not the scaling), or eight
positions on the CPU with --device cpu.

Run:  python examples_torch/multichip_and_scale.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import scipy.sparse as sp
import torch

import atlite_tpu_torch as att
from atlite_tpu_torch import ExclusionContainer
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.core.mesh import (
    NamedSharding,
    field_spec,
    make_mesh,
    put_global,
    sharded_aggregate_banded,
)
from atlite_tpu_torch.gis.geometry import box
from atlite_tpu_torch.gis.raster import Raster

POSITIONS = 8


def mesh_devices(device):
    """POSITIONS mesh positions over the visible cards in turn, or the CPU."""
    if device == "cpu":
        return [torch.device("cpu")] * POSITIONS
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not cards:
        raise RuntimeError("no CUDA card is available; pass --device cpu")
    return [cards[i % len(cards)] for i in range(POSITIONS)]


def main(device):
    cutout = att.Cutout(device=device, module="synthetic", x=slice(-8, 7.75),
                        y=slice(48, 55.75), time="2013-06")
    cutout.prepare()

    # cutout sharded over a ("t", "x") mesh
    devices = mesh_devices(device)
    mesh = make_mesh(devices)
    print(f"mesh: {dict(mesh.shape)} over {len(set(devices))} distinct device(s)")
    cutout.shard(mesh)  # blocks placed per position; converters run block by block
    regions = {f"r{i}": box(-8 + 3 * i, 49, -5.5 + 3 * i, 54) for i in range(5)}
    cf = cutout.pv(panel="CSi", orientation="latitude_optimal", shapes=regions,
                   index=list(regions), per_unit=True, aggregate_time=None)
    print("sharded PV capacity factors, hours 12-14:")
    for name, row in zip(regions, cf.values):
        print(f"  {name}  {np.round(row[12:15], 3).tolist()}")
    cutout.unshard()

    # availability on the device path
    rng = np.random.default_rng(0)
    landuse = Raster(rng.integers(1, 6, (800, 1600)).astype(np.uint8),
                     Affine(0.01, 0, -8.2, 0, -0.01, 56.2), 4326, 255)
    excluder = ExclusionContainer(crs=4326, res=0.01)
    excluder.add_raster(landuse, codes=[5])  # exclude one land-use class (~20%)
    A = cutout.availabilitymatrix(regions, excluder, backend="device").values
    print("eligible cell-equivalents per region:", np.round(A.sum(axis=(1, 2)), 1).tolist(),
          "(~80% of each region's cells: one of five codes excluded)")

    # a large matrix: the banded aggregation over the mesh
    Y, X = cutout.shape
    B = 64
    rows, cols, vals = [], [], []
    for b in range(B):
        y0, x0 = rng.integers(0, Y - 4), rng.integers(0, X - 4)
        cc = (np.arange(y0, y0 + 4)[:, None] * X + np.arange(x0, x0 + 4)[None, :]).ravel()
        rows += [b] * len(cc)
        cols += list(cc)
        vals += list(rng.random(len(cc)))
    matrix = sp.csr_matrix((vals, (rows, cols)), shape=(B, Y * X))
    if X % mesh.shape["x"] == 0:
        agg = sharded_aggregate_banded(mesh, matrix, Y, X, block_b=16, align=64)
        field = cutout.fields()["temperature"]
        out = agg(put_global(field, NamedSharding(mesh, field_spec()))).gather()
        print("banded sharded aggregation:", tuple(out.shape),
              "finite:", bool(torch.isfinite(out).all()))
    else:
        print("X does not divide the mesh x axis; skipping the banded demo")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(parser.parse_args().device)
