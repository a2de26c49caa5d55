"""Turbine and solar-panel configurations (counterpart of
``atlite_tpu/resource.py``).

The JAX package reads its configurations from YAML files; the port holds
the two it needs so far as Python literals, copied from
``atlite_tpu/resources/windturbine/Vestas_V112_3MW.yaml`` and
``atlite_tpu/resources/solarpanel/CSi.yaml`` (data: contributors to
atlite, CC-BY-4.0).  Any other name raises ``KeyError``.
"""

from __future__ import annotations

import copy
import logging

import numpy as np

logger = logging.getLogger(__name__)

_NOT_PORTED = ("is not among the configurations the port holds so far; the "
               "others wait for a later slice (ROADMAP queue 1, item 10)")

WINDTURBINES = {
    "Vestas_V112_3MW": {
        "name": "V112 3MW",
        "manufacturer": "Vestas",
        "source": "http://nozebra.ipapercms.dk/Vestas/Communication/Productbrochure/"
                  "V11230MW/V11230MWOffshoreUK/",
        "HUB_HEIGHT": 80.0,
        "V": [0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 25, 25],
        "POW": [0, 0, 0.005, 0.15, 0.3, 0.525, 0.905, 1.375, 1.95, 2.58, 2.96,
                3.05, 3.06, 3.06, 0],
    },
}

SOLARPANELS = {
    "CSi": {
        "model": "huld",
        "name": "CSi",
        "source": "Huld 2010",
        "efficiency": 0.1,
        "c_temp_amb": 1,
        "c_temp_irrad": 0.035,
        "r_tamb": 293,
        "r_tmod": 298,
        "r_irradiance": 1000,
        "k_1": -0.017162,
        "k_2": -0.040289,
        "k_3": -0.004681,
        "k_4": 0.000148,
        "k_5": 0.000169,
        "k_6": 5.0e-06,
        "inverter_efficiency": 0.9,
    },
}


def _lookup(table, name, kind):
    key = str(name).replace(".yaml", "")
    if key not in table:
        raise KeyError(f"{kind} {name!r} {_NOT_PORTED}")
    return copy.deepcopy(table[key])


def get_windturbineconfig(turbine, add_cutout_windspeed=True):
    """A validated turbine config {V, POW, hub_height, P} from a name or a
    dict."""
    if isinstance(turbine, str):
        raw = _lookup(WINDTURBINES, turbine, "turbine")
        conf = dict(V=np.array(raw["V"], dtype=float),
                    POW=np.array(raw["POW"], dtype=float),
                    hub_height=raw["HUB_HEIGHT"],
                    P=float(np.max(raw["POW"])))
    elif isinstance(turbine, dict):
        conf = turbine
    else:
        raise KeyError(f"`turbine` must be a str or dict, but is {type(turbine)}.")
    return _validate_turbine_config_dict(conf, add_cutout_windspeed)


def get_solarpanelconfig(panel):
    """A panel config dict from a name."""
    if not isinstance(panel, str):
        raise KeyError(f"`panel` must be a str, but is {type(panel)}.")
    return _lookup(SOLARPANELS, panel, "panel")


def _max_v_is_zero_pow(turbine):
    return np.any(turbine["POW"][turbine["V"] == turbine["V"].max()] == 0)


def _validate_turbine_config_dict(turbine, add_cutout_windspeed):
    """Check the curve's keys, lengths and ascending speeds; optionally
    append a cut-out speed."""
    if not all(k in turbine for k in ("POW", "V", "P", "hub_height")):
        raise ValueError(
            "turbine config dict needs at least the following keys: "
            f"['POW', 'V', 'P', 'hub_height'] but are currently: {list(turbine)}")
    if not all(isinstance(turbine[p], (np.ndarray, list)) for p in ("POW", "V")):
        raise ValueError("turbine entries 'POW' and 'V' must be np.ndarray or list")
    turbine = dict(turbine)
    turbine["V"] = np.asarray(turbine["V"], dtype=float)
    turbine["POW"] = np.asarray(turbine["POW"], dtype=float)
    if len(turbine["POW"]) != len(turbine["V"]):
        raise ValueError("turbine wind speed and power arrays do not have equal length.")
    if not np.all(np.diff(turbine["V"]) >= 0):
        raise ValueError("wind speed 'V' in the turbine config dict is expected to be "
                         f"increasing, but is currently not in ascending order:\n{turbine['V']}")
    if add_cutout_windspeed is True and not _max_v_is_zero_pow(turbine):
        turbine["V"] = np.pad(turbine["V"], (0, 1), "maximum")
        turbine["POW"] = np.pad(turbine["POW"], (0, 1), constant_values=0)
    if not _max_v_is_zero_pow(turbine):
        logger.warning("The power curve does not have a cut-out wind speed, i.e. the "
                       "power output corresponding to the highest wind speed is not zero.")
    return turbine
