"""Entry points of the headline step (counterparts of
``__graft_entry__._example_inputs``/``_step_fn``/``entry`` and
``bench.build_inputs``).

The step turns stored weather fields into wind and PV bus series.  On a
CUDA card it runs as one fused kernel (``ops/csrc/megakernel.cu``); on the
CPU the same call runs the plain modules.  Inputs are made by the JAX
package's recipe, with numpy alone, and ``from_jax_inputs`` carries either
package's numpy inputs onto a device.
"""

from __future__ import annotations

import numpy as np
import torch

from atlite_tpu_torch.core.timeutil import solar_ephemeris
from atlite_tpu_torch.datasets import synthetic
from atlite_tpu_torch.ops.megakernel import FIELD_ORDER, knot_table, wind_pv_bus_megakernel
from atlite_tpu_torch.physics.wind import simplify_power_curve

# the panel of __graft_entry__._step_fn
PANEL = {
    "model": "huld", "efficiency": 0.17, "r_irradiance": 1000.0,
    "r_tmod": 298.0, "c_temp_amb": 1.0, "c_temp_irrad": 0.035,
    "inverter_efficiency": 0.9, "k_1": -0.017162, "k_2": -0.040289,
    "k_3": -0.004681, "k_4": 0.000148, "k_5": 0.000169, "k_6": 0.000005,
}
HUB_HEIGHT = 80.0


def example_inputs(T=24, Y=16, X=32, B=4, seed=7,
                   extent=(-10, 5, 40, 55), start="2013-06-01",
                   density=0.2, matrix_seed=0, vin=3.0):
    """Synthetic numpy inputs of the step, by the recipe of
    ``__graft_entry__._example_inputs``: (fields, eph, lon, lat, V, POWn,
    matrix)."""
    x = np.linspace(extent[0], extent[1], X)
    y = np.linspace(extent[2], extent[3], Y)
    times = np.datetime64(start, "ns") + np.arange(T) * np.timedelta64(1, "h")
    fields = {}
    for feature in ("wind", "influx", "temperature", "height"):
        for var, (dims, arr) in synthetic.generate(feature, x, y, times, seed).items():
            fields[var] = np.asarray(arr, dtype=np.float32)
    eph = {k: np.asarray(v, dtype=np.float32)
           for k, v in solar_ephemeris(times).items()}

    rng = np.random.default_rng(matrix_seed)
    matrix = rng.random((B, Y * X), dtype=np.float32)
    matrix *= rng.random((B, Y * X)) < density

    # simple cubic-ramp power curve
    V = np.arange(0.0, 26.0, 0.5, dtype=np.float32)
    POWn = np.clip((V**3 - vin**3) / (12.0**3 - vin**3), 0, 1).astype(np.float32)
    POWn[V >= 25.0] = 0.0
    return fields, eph, x.astype(np.float32), y.astype(np.float32), V, POWn, matrix


def build_inputs(T, Y, X, B, seed=3):
    """Inputs at a bench shape, by the recipe of ``bench.build_inputs``:
    Europe at 0.25 deg, a winter start, a sparser bus matrix and the
    simplified power curve."""
    fields, eph, x, y, V, POWn, matrix = example_inputs(
        T=T, Y=Y, X=X, B=B, seed=seed, extent=(-12.0, 18.0, 35.0, 60.0),
        start="2013-01-01", density=0.05)
    V, POWn = (a.astype(np.float32) for a in simplify_power_curve(V, POWn))
    return fields, eph, x, y, V, POWn, matrix


def resolve_device(device=None) -> torch.device:
    """The device to run on: the given one, else the current CUDA card.
    Without a card, asking for the default raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass device='cpu' "
                           "to run the plain version on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def from_jax_inputs(fields, eph, lon, lat, V, POWn, matrix, device=None):
    """Carry numpy inputs (as either package makes them) to tensors on a
    device, float32 where they are floating point."""
    device = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return ({k: put(v) for k, v in fields.items()},
            {k: put(v) for k, v in eph.items()},
            put(lon), put(lat), put(V), put(POWn), put(matrix))


def step_fn():
    """The headline step: ``step(fields, eph, lon, lat, V, POWn, matrix) ->
    (wind_bus, pv_bus)``, each (T, B), with the signature of
    ``__graft_entry__._step_fn``.  ``eph`` is unused: the step takes the
    stored solar angles.  The step keeps the kernel's knot table of the
    power curve it was last given, and builds it again when the curve's
    tensors are other ones or were written since."""
    last = {"V": None, "POWn": None, "versions": None, "table": None}

    def step(fields, eph, lon, lat, V, POWn, matrix):
        T, Y, X = fields["wnd100m"].shape
        flat = {k: fields[k].reshape(T, Y * X) for k in FIELD_ORDER}
        lat_cell = lat.repeat_interleave(X)
        versions = (V._version, POWn._version)
        if last["V"] is not V or last["POWn"] is not POWn or last["versions"] != versions:
            last.update(V=V, POWn=POWn, versions=versions, table=knot_table(V, POWn))
        return wind_pv_bus_megakernel(flat, lat_cell, matrix, V, POWn, PANEL,
                                      hub_height=HUB_HEIGHT, table=last["table"])

    return step


def entry(device=None):
    """(step, example_args) with the example inputs on ``device`` (default:
    the CUDA card; raises without one)."""
    device = resolve_device(device)
    args = from_jax_inputs(*example_inputs(), device=device)
    return step_fn(), args
