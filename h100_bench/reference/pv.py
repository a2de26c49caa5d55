"""Reference of ``Cutout.pv``: fixed or horizontally tracking panels,
the 'simple' transposition and the Huld model."""

from h100_bench.reference import physics

FIELDS = ("influx_toa", "influx_direct", "influx_diffuse", "albedo", "solar_altitude",
          "solar_azimuth", "temperature")
# relative L2 gap of a per-unit series; set from the readings in PERF.md
# section 6 (sound runs 1.41e-7, the bfloat16 control 2.81e-3)
LIMIT = 1e-4


def cell_values(f, lat, kwargs):
    return physics.pv_cf(f, lat, kwargs["panel"], kwargs["orientation"], kwargs.get("tracking"))
