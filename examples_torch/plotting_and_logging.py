"""Plotting and log messages with the port: a capacity-factor map with
the grid's cells, an eligible-area map, and the package's logging sent
to a file.

The counterpart of examples/plotting_and_logging.py, with plain
matplotlib.  Writes its PNGs and its log to a temporary directory (or to
--out).

Run:  python examples_torch/plotting_and_logging.py [--device cpu] [--out DIR]
"""

import argparse
import logging
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

import atlite_tpu_torch as att
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.gis.geometry import box
from atlite_tpu_torch.gis.raster import Raster


def main(device, out):
    log_file = out / "atlite.log"
    # every module logs through the standard library's logging
    logging.basicConfig(filename=log_file, filemode="w", level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    logging.getLogger("atlite_tpu_torch").setLevel(logging.DEBUG)

    cutout = att.Cutout(out / "plotting", device=device, module="synthetic",
                        x=slice(-10.0, 2.0), y=slice(49.0, 59.0), time="2013-06-01")
    cutout.prepare(features=["wind", "influx", "temperature"])

    # capacity-factor map, with the grid's cell outlines
    field = cutout.pv(panel="CSi", orientation="latitude_optimal", aggregate_time="mean").values
    fig, ax = plt.subplots(figsize=(7, 6))
    x0, x1, y0, y1 = cutout.extent
    im = ax.imshow(field, origin="lower", extent=(x0, x1, y0, y1), cmap="inferno")
    fig.colorbar(im, ax=ax, label="PV capacity factor (mean)")
    cells = cutout.grid["geometry"]
    for geom in cells[:: max(1, len(cells) // 400)]:
        gx0, gy0, gx1, gy1 = geom.bounds
        ax.add_patch(plt.Rectangle((gx0, gy0), gx1 - gx0, gy1 - gy0, fill=False, lw=0.2,
                                   ec="w", alpha=0.5))
    ax.set(xlabel="lon", ylabel="lat", title="Mean PV capacity factor")
    fig.savefig(out / "pv-cf.png", dpi=120)
    print(f"wrote {out / 'pv-cf.png'}")

    # eligible-area map
    rng = np.random.default_rng(0)
    landuse = Raster(rng.integers(1, 6, (500, 600)).astype(np.uint8),
                     Affine(0.02, 0, -10.2, 0, -0.02, 59.2), 4326, 255)
    excluder = att.ExclusionContainer(crs=4326, res=0.02)
    excluder.add_raster(landuse, codes=[4, 5])
    fig, ax = plt.subplots(figsize=(6, 6))
    excluder.plot_shape_availability(box(-6.0, 52.0, -2.0, 56.0), ax=ax)
    fig.savefig(out / "availability.png", dpi=120)
    print(f"wrote {out / 'availability.png'}")

    logging.shutdown()
    lines = log_file.read_text().splitlines()
    print(f"\ncaptured {len(lines)} log lines in {log_file}; tail:")
    for line in lines[-3:]:
        print(" ", line)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--out", type=Path, help="directory for the PNGs and the log")
    args = parser.parse_args()
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        main(args.device, args.out)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(args.device, Path(tmp))
