"""End to end on the port: cutout creation -> preparation -> wind/PV series.

The counterpart of examples/create_cutout_and_generate.py with the
offline synthetic weather module; regions are a dict of shapes, results
are DataArrays whose ``values`` are numpy arrays.  For ERA5 files use
module="era5" with era5_files=...; SARAH archives with module="sarah",
sarah_dir=... .

Run:  python examples_torch/create_cutout_and_generate.py [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import atlite_tpu_torch as att
from atlite_tpu_torch.gis.geometry import box


def summary(da):
    """Mean and max of each region's series."""
    names = da.coords[da.dims[0]]
    return {str(n): (round(float(v.mean()), 4), round(float(v.max()), 4))
            for n, v in zip(names, da.values)}


def main(device):
    with tempfile.TemporaryDirectory() as tmp:
        cutout = att.Cutout(Path(tmp) / "western-europe-2013-01", device=device,
                            module="synthetic", x=slice(-13.7, 1.8), y=slice(49.8, 60.3),
                            time="2013-01-01")
        cutout.prepare()
        print(cutout)

        # per-cell capacity-factor series
        cf = cutout.wind("Vestas_V112_3MW", aggregate_time=None)
        print("\nwind CF: mean", float(cf.values.mean()))

        # aggregate to two regions with per-unit normalisation; a dict's
        # keys label the rows when given as the index
        regions = {"north": box(-13.7, 55.0, 1.8, 60.3), "south": box(-13.7, 49.8, 1.8, 55.0)}
        wind = cutout.wind("Vestas_V112_3MW", shapes=regions, index=list(regions),
                           per_unit=True, aggregate_time=None)
        print("\nregional wind CF (p.u.), (mean, max):", summary(wind))
        pv = cutout.pv(panel="CSi", orientation="latitude_optimal", shapes=regions,
                       index=list(regions), per_unit=True, aggregate_time=None)
        print("regional PV CF (p.u.), (mean, max):", summary(pv))

        # cutouts too large for device memory stream in time chunks;
        # stream_pack="int16" stages each chunk CF-packed (half the bytes)
        streamed = cutout.wind("Vestas_V112_3MW", shapes=regions, index=list(regions),
                               per_unit=True, aggregate_time=None, time_chunk=12,
                               stream_pack="int16")
        drift = float(np.abs(streamed.values - wind.values).max())
        print(f"\nstreamed int16-packed wind CF: max deviation {drift:.2e}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(parser.parse_args().device)
