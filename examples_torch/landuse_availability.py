"""Land eligibility on the port: an availability matrix from a land-use
raster and a protected area, then capacity-weighted wind profiles.

The counterpart of examples/landuse_availability.py.  On a card the
availability matrix runs on the card; on a CPU cutout, on the host.

Run:  python examples_torch/landuse_availability.py [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import atlite_tpu_torch as att
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.gis.geometry import box
from atlite_tpu_torch.gis.raster import Raster


def main(device):
    with tempfile.TemporaryDirectory() as tmp:
        cutout = att.Cutout(Path(tmp) / "availability", device=device, module="synthetic",
                            x=slice(-4, 1.5), y=slice(56, 62), time="2013-01-01")
        cutout.prepare(features=["wind"])

        # a CORINE-like land-use raster at 0.01 deg with classes 1..5
        rng = np.random.default_rng(0)
        landuse = Raster(rng.integers(1, 6, size=(640, 580)).astype(np.uint8),
                         Affine(0.01, 0, -4.2, 0, -0.01, 62.2), crs=4326, nodata=255)
        excluder = att.ExclusionContainer(crs=4326, res=0.01)
        excluder.add_raster(landuse, codes=[4, 5])            # exclude classes 4, 5
        excluder.add_geometry([box(-2.0, 58.0, -1.0, 59.0)])  # a protected area

        regions = {"A": box(-4, 56, -1.25, 62), "B": box(-1.25, 56, 1.5, 62)}
        A = cutout.availabilitymatrix(regions, excluder).values
        print("availability mean share per region:",
              {k: round(float(a[a > 0].mean()), 3) for k, a in zip(regions, A)})

        # capacity layout: 2 MW/km^2 on eligible land
        area_km2 = cutout.area(crs=3035).values / 1e6
        cap_per_region = A * area_km2[None] * 2.0  # MW
        print("\ncapacity-weighted wind profiles (p.u.), mean / max:")
        for name, cap in zip(regions, cap_per_region):
            ts = cutout.wind("Vestas_V112_3MW", layout=cutout.uniform_layout().copy(cap),
                             per_unit=True, aggregate_time=None).values[0]
            print(f"  {name}  {ts.mean():.4f} {ts.max():.4f}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(parser.parse_args().device)
