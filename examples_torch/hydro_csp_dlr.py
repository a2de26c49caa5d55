"""Hydro inflow, CSP and dynamic line rating on the port.

The counterpart of examples/hydro_csp_dlr.py: basins and plants are
given as dicts of columns, lines as a list of LineStrings.

Run:  python examples_torch/hydro_csp_dlr.py [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import atlite_tpu_torch as att
from atlite_tpu_torch.gis.geometry import LineString, box


def main(device):
    with tempfile.TemporaryDirectory() as tmp:
        cutout = att.Cutout(Path(tmp) / "hydro-csp", device=device, module="synthetic",
                            x=slice(-4, 1.5), y=slice(56, 62),
                            time=slice("2013-01-01", "2013-01-03"))
        cutout.prepare()

        # hydro: a cascade of three basins routed to one plant
        hydrobasins = {"HYBAS_ID": [10, 20, 30], "NEXT_DOWN": [0, 10, 20],
                       "DIST_MAIN": [100.0, 150.0, 230.0],
                       "geometry": [box(-3.0, 56.5, -1.5, 58.0), box(-1.5, 56.5, 0.0, 58.0),
                                    box(0.0, 56.5, 1.5, 58.0)]}
        plants = {"lon": [-2.25], "lat": [57.25]}
        inflow = cutout.hydro(plants, hydrobasins, flowspeed=1).values
        print(f"hydro inflow [m^3/h] of one plant: mean {inflow.mean():.4g}, "
              f"max {inflow.max():.4g}")

        csp = cutout.csp("SAM_solar_tower", aggregate_time=None).values
        print(f"\nCSP specific generation: mean {csp.mean():.4f} max {csp.max():.4f}")

        # dynamic line rating of two corridors
        lines = {"west-east": LineString([(-3.5, 57.0), (1.0, 57.5)]),
                 "south-north": LineString([(-1.5, 56.3), (-1.0, 61.5)])}
        rating = cutout.line_rating(list(lines.values()), line_resistance=1e-4).values
        print("\nline rating [A], min / mean / max:")
        for name, r in zip(lines, rating):
            print(f"  {name:<12} {r.min():.1f} {r.mean():.1f} {r.max():.1f}")
        assert np.isfinite(rating).all()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(parser.parse_args().device)
