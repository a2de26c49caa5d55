"""Building-stock weighted weather on the port: population-weighted
temperature and heat demand per region.

The counterpart of examples/building_stock_weather_aggregation.py: a
layout of population around two city centres weights the aggregation;
per-unit divides by each region's layout total.

Run:  python examples_torch/building_stock_weather_aggregation.py [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import atlite_tpu_torch as att
from atlite_tpu_torch.gis.geometry import box


def main(device):
    with tempfile.TemporaryDirectory() as tmp:
        cutout = att.Cutout(Path(tmp) / "building-stock", device=device, module="synthetic",
                            x=slice(5.0, 15.0), y=slice(47.0, 55.0),
                            time=slice("2013-01-01", "2013-01-31"))
        cutout.prepare(features=["temperature", "influx"])

        # two "countries", split at 51N
        regions = {"north": box(5.0, 51.0, 15.0, 55.0), "south": box(5.0, 47.0, 15.0, 51.0)}
        names = list(regions)

        # a building-stock layout: population clustered around two cities
        lon = np.asarray(cutout.grid_desc.x)[None, :]
        lat = np.asarray(cutout.grid_desc.y)[:, None]
        pop = (np.exp(-((lon - 13.4) ** 2 + (lat - 52.5) ** 2) / 0.8)     # Berlin
               + np.exp(-((lon - 11.6) ** 2 + (lat - 48.1) ** 2) / 0.8))  # Munich
        layout = cutout.uniform_layout().copy(pop)

        temp = cutout.temperature(shapes=regions, index=names, layout=layout, per_unit=True,
                                  aggregate_time=None).values
        print("population-weighted January temperature (degC), mean / min / max:")
        for n, v in zip(names, temp):
            print(f"  {n:<6} {v.mean():8.3f} {v.min():8.3f} {v.max():8.3f}")

        area = cutout.temperature(shapes=regions, index=names, per_unit=True,
                                  aggregate_time=None).values
        print("\nweighted-minus-area-mean bias per region (degC):")
        for n, d in zip(names, temp.mean(axis=1) - area.mean(axis=1)):
            print(f"  {n:<6} {d:.3f}")

        # degree-day heat demand, building-stock weighted, one value a day
        demand = cutout.heat_demand(threshold=15.0, a=1.0, shapes=regions, index=names,
                                    layout=layout, aggregate_time=None)
        print(f"\nheat demand over {demand.sizes['time']} days, mean / max a day:")
        for n, v in zip(names, demand.values):
            print(f"  {n:<6} {v.mean():.2f} {v.max():.2f}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(parser.parse_args().device)
