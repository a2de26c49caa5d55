"""Satellite irradiance and bathymetry/elevation on the port: a cutout
from a SARAH archive (with the synthetic module's temperature), PV on
it, and GEBCO-like heights resampled onto a cutout grid.

The counterpart of examples/sarah_and_gebco.py; the archive is the one
under tests/data/sarah.

Run:  python examples_torch/sarah_and_gebco.py [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import atlite_tpu_torch as att
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.datasets import gebco
from atlite_tpu_torch.gis.raster import Raster

SARAH_DIR = Path(__file__).resolve().parent.parent / "tests" / "data" / "sarah"


def main(device):
    with tempfile.TemporaryDirectory() as tmp:
        cutout = att.Cutout(Path(tmp) / "sarah", device=device, module=["sarah", "synthetic"],
                            sarah_dir=str(SARAH_DIR), x=slice(-4.95, -4.21),
                            y=slice(56.05, 56.61), time=slice("2013-05-01", "2013-05-02 23:00"),
                            dx=0.05, dy=0.05)
        cutout.prepare(features=["influx", "temperature"])
        print(cutout)

        direct = np.asarray(cutout.data["influx_direct"])
        print(f"\nSARAH direct influx: peak {direct.max():.1f} W/m^2, "
              f"day-1 noon field mean {direct[12].mean():.1f} W/m^2")
        pv = cutout.pv(panel="CSi", orientation="latitude_optimal", aggregate_time="mean")
        print(f"two-day mean PV CF on satellite irradiance: {float(pv.values.mean()):.4f}")

    # a GEBCO-like elevation tile at 0.05 deg (a GeoTIFF or .npz path
    # works the same through gebco_path=...)
    ny, nx = 60, 60
    elev = np.full((ny, nx), 120.0)
    elev[: ny // 2] = 420.0  # the northern half is high ground
    tile = Raster(elev, Affine(0.05, 0, -2.2, 0, -0.05, 52.2), crs=4326, nodata=None)
    c2 = att.Cutout(device=device, module="gebco", x=slice(-2, 0), y=slice(50, 52),
                    time="2013-01-01")
    dims, height = gebco.get_data(c2, "height", gebco_raster=tile)["height"]
    print(f"\nGEBCO height on the cutout grid {height.shape}: south rows "
          f"~{height[0].mean():.0f} m, north rows ~{height[-1].mean():.0f} m")
    assert height[-1].mean() > height[0].mean()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(parser.parse_args().device)
