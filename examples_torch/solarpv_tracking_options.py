"""PV under each tracking mode on the port, over a July week.

The counterpart of examples/solarpv_tracking_options.py; the hierarchy
dual >= vertical 1-axis >= fixed holds.

Run:  python examples_torch/solarpv_tracking_options.py [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import atlite_tpu_torch as att

MODES = {
    "fixed (latitude-optimal tilt)": None,
    "horizontal 1-axis (E-W rotation)": "horizontal",
    "tilted horizontal 1-axis": "tilted_horizontal",
    "vertical 1-axis (azimuth drive)": "vertical",
    "dual 2-axis": "dual",
}


def main(device):
    with tempfile.TemporaryDirectory() as tmp:
        cutout = att.Cutout(Path(tmp) / "tracking", device=device, module="synthetic",
                            x=slice(-6.0, 4.0), y=slice(40.0, 48.0), dx=0.5, dy=0.5,
                            time=slice("2013-07-01", "2013-07-07"))
        cutout.prepare(features=["influx", "temperature"])
        means = {label: float(cutout.pv(panel="CSi", orientation="latitude_optimal",
                                        tracking=tracking, aggregate_time="mean").values.mean())
                 for label, tracking in MODES.items()}

    width = max(len(k) for k in means)
    print("mean capacity factor over the July week:")
    for label, value in means.items():
        print(f"  {label:<{width}}  {value:.4f}")
    assert means["dual 2-axis"] >= means["vertical 1-axis (azimuth drive)"]
    assert means["vertical 1-axis (azimuth drive)"] >= means["fixed (latitude-optimal tilt)"]
    print("\ntracking hierarchy dual >= 1-axis >= fixed holds")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(parser.parse_args().device)
