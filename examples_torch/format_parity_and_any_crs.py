"""File formats and any-CRS exclusion on the port: a compressed NETCDF4
cutout round trip, availability from a raster on the Swiss national grid
(EPSG:2056), and a zstd NETCDF4 file written and read back.

The counterpart of examples/format_parity_and_any_crs.py.  EPSG:2056
(oblique Mercator) has no closed form in the port: its host path goes
through the system PROJ's cs2cs, and that part is skipped, with a note,
where cs2cs is not installed (as the zstd part is without libzstd).

Run:  python examples_torch/format_parity_and_any_crs.py [--device cpu]
"""

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import atlite_tpu_torch as att
from atlite_tpu_torch import ExclusionContainer
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.gis.crs import transform_points
from atlite_tpu_torch.gis.geometry import box
from atlite_tpu_torch.gis.raster import Raster
from atlite_tpu_torch.io import zstd
from atlite_tpu_torch.io.hdf5 import read_netcdf4
from atlite_tpu_torch.io.hdf5_write import write_netcdf4


def main(device):
    tmp = Path(tempfile.mkdtemp())
    try:
        # compressed NETCDF4 cutout
        cutout = att.Cutout(device=device, module="synthetic", x=slice(6.5, 9.5),
                            y=slice(45.8, 47.5), time="2013-01-01")
        cutout.prepare(compression={"zlib": True, "complevel": 4, "shuffle": True})
        nc = tmp / "swiss-cutout.nc"
        cutout.to_netcdf(nc)
        print(f"wrote {nc.name}: {nc.stat().st_size / 1e6:.2f} MB, "
              f"magic={nc.read_bytes()[:4]!r} (HDF5 container)")
        reloaded = att.Cutout(nc, device=device)
        w1 = cutout.wind("Vestas_V112_3MW", aggregate_time=None).values
        w2 = reloaded.wind("Vestas_V112_3MW", aggregate_time=None).values
        print("round-trip wind CF maxdiff:", float(np.abs(w1 - w2).max()))

        # any-CRS availability: an exclusion raster on EPSG:2056
        rng = np.random.default_rng(0)
        if shutil.which("cs2cs") is None:
            print("PROJ's cs2cs not found; skipping the EPSG:2056 availability demo")
        else:
            px, py = transform_points(np.array([6.5, 9.5]), np.array([45.8, 47.5]), 4326, 2056)
            RY, RX = 800, 1000
            landuse = Raster(rng.integers(1, 6, (RY, RX)).astype(np.uint8),
                             Affine((px[1] - px[0] + 2e4) / RX, 0, px[0] - 1e4,
                                    0, -(py[1] - py[0] + 2e4) / RY, py[1] + 1e4),
                             crs=2056, nodata=255)
            excluder = ExclusionContainer(crs=2056, res=300)
            excluder.add_raster(landuse, codes=[4, 5])  # exclude classes 4 and 5
            regions = {"west": box(6.6, 45.9, 8.0, 47.4), "east": box(8.0, 45.9, 9.4, 47.4)}
            avail = cutout.availabilitymatrix(regions, excluder, backend="host").values
            share = avail.mean(axis=(1, 2))
            print("mean availability (EPSG:2056 excluder):",
                  dict(zip(regions, np.round(share, 3).tolist())))

        # zstd NETCDF4
        if zstd.available():
            zfn = tmp / "zstd.nc"
            data = rng.random((24, 8, 9)).astype("f4")
            write_netcdf4(zfn, {"time": 24, "y": 8, "x": 9},
                          {"time": (("time",), np.arange(24, dtype="i8"),
                                    {"units": "hours since 2013-01-01"}),
                           "ssrd": (("time", "y", "x"), data, {})},
                          {}, compression="zstd")
            _, variables, _ = read_netcdf4(zfn)
            assert np.array_equal(variables["ssrd"][1], data)
            print(f"zstd NETCDF4 round-trip OK ({zfn.stat().st_size} bytes)")
        else:
            print("libzstd not present; skipping the zstd demo")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(parser.parse_args().device)
