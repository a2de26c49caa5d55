"""Reference of ``Cutout.wind``: the turbine's capacity factor from the
wind speed at 100 m, taken to hub height by the log law."""

from h100_bench.reference import physics

FIELDS = ("wnd100m", "roughness")
# relative L2 gap of a per-unit series; set from the readings in PERF.md
# section 6 (sound runs 1.41e-7, the bfloat16 control 2.81e-3)
LIMIT = 1e-4


def cell_values(f, lat, kwargs):
    return physics.wind_cf(f, kwargs["turbine"], kwargs.get("hub_height"),
                           kwargs.get("add_cutout_windspeed", True))
