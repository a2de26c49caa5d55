"""Turbine, solar-panel and CSP-installation configurations (counterpart
of ``atlite_tpu/resource.py``).

Turbines, panels and CSP installations are read from copies of the JAX
package's files under ``resources/`` (data: contributors to atlite,
CC-BY-4.0; each file keeps its attribution header) by ``load_yaml``, a
reader of the flat subset they use, so the port needs no PyYAML.  The
registries ``windturbines``, ``solarpanels`` and ``cspinstallations`` map
each ``*.yaml`` stem to its file; a file outside them (such as the
extensionless ``eno_126_*`` turbines) is read by its ``Path``.  The OEDB
turbine search (``oedb:`` names) downloads, and is not ported.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

RESOURCE_DIRECTORY = Path(__file__).parent / "resources"
WINDTURBINE_DIRECTORY = RESOURCE_DIRECTORY / "windturbine"
SOLARPANEL_DIRECTORY = RESOURCE_DIRECTORY / "solarpanel"
CSPINSTALLATION_DIRECTORY = RESOURCE_DIRECTORY / "cspinstallation"


class arrowdict(dict):
    """A dict whose keys read as attributes too."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __dir__(self):
        return list(super().__dir__()) + list(self)


windturbines = arrowdict({p.stem: p for p in sorted(WINDTURBINE_DIRECTORY.glob("*.yaml"))})
solarpanels = arrowdict({p.stem: p for p in sorted(SOLARPANEL_DIRECTORY.glob("*.yaml"))})
cspinstallations = arrowdict(
    {p.stem: p for p in sorted(CSPINSTALLATION_DIRECTORY.glob("*.yaml"))})

# ---------------------------------------------------------------------------
# YAML subset: comments, ``key: scalar``, nested block mappings, one-line
# flow lists; scalars resolve as YAML 1.1 (PyYAML's ``safe_load``) does
# ---------------------------------------------------------------------------
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_SPECIAL = {".inf": np.inf, ".Inf": np.inf, ".INF": np.inf, "+.inf": np.inf, "+.Inf": np.inf,
            "+.INF": np.inf, "-.inf": -np.inf, "-.Inf": -np.inf, "-.INF": -np.inf,
            ".nan": np.nan, ".NaN": np.nan, ".NAN": np.nan}
# forms YAML 1.1 gives a meaning this reader does not implement
_UNSUPPORTED = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                          r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                          r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|[&*!|>%@`{].*|<<")


def _scalar(text):
    """A plain or quoted scalar, resolved as ``yaml.safe_load`` does."""
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"' and "\\" not in text:
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if text in _SPECIAL:
        return float(_SPECIAL[text])
    if _UNSUPPORTED.fullmatch(text) or text[:1] in "\"'":
        raise ValueError(f"YAML scalar {text!r} is outside the subset load_yaml reads")
    return text


def _value(text):
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"flow list {text[:40]!r}... must close on its line")
        inner = text[1:-1].strip()
        return [_scalar(item.strip()) for item in inner.split(",")] if inner else []
    return _scalar(text)


def _block(lines, i, indent):
    """The mapping whose keys sit at ``indent``, from line ``i``; returns
    (mapping, next line)."""
    out = {}
    while i < len(lines):
        ind, text, lineno = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"line {lineno}: unexpected indentation")
        m = re.fullmatch(r"([^\s:#][^:#]*?)\s*:(?:\s+(.*))?", text)
        if m is None:
            raise ValueError(f"line {lineno}: not a 'key: value' line: {text!r}")
        key, rest = _scalar(m.group(1)), (m.group(2) or "").strip()
        i += 1
        if rest:
            out[key] = _value(rest)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def load_yaml(path):
    """Read a YAML file of the subset the configuration files use; the
    result equals ``yaml.safe_load``'s (``None`` the word stays a string,
    ``1000`` is an int, ``5.0e-06`` a float)."""
    lines = []
    with open(path, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            text = re.sub(r"(^|\s)#.*$", "", raw.rstrip("\n")).rstrip()
            if text.strip() in ("", "---"):
                continue
            if "\t" in text[:len(text) - len(text.lstrip())]:
                raise ValueError(f"line {lineno}: tab in indentation")
            lines.append((len(text) - len(text.lstrip(" ")), text.strip(), lineno))
    if not lines:
        return None
    out, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"line {lines[i][2]}: unexpected indentation")
    return out


def _resolve(name, registry, kind):
    """The file of a named configuration, or the given path."""
    if isinstance(name, Path):
        return name
    if not isinstance(name, str):
        raise KeyError(f"`{kind}` must be a str or pathlib.Path, but is {type(name)}.")
    key = name.replace(".yaml", "")
    if key not in registry:
        raise KeyError(f"unknown {kind} {name!r}; available: {sorted(registry)}")
    return registry[key]


def get_windturbineconfig(turbine, add_cutout_windspeed=True):
    """A validated turbine config {V, POW, hub_height, P} from a registry
    name, a ``Path`` to a turbine file, or a dict."""
    if not isinstance(turbine, (str, Path, dict)):
        raise KeyError(f"`turbine` must be a str, pathlib.Path or dict, but is {type(turbine)}.")
    if isinstance(turbine, str) and turbine.startswith("oedb:"):
        raise NotImplementedError(
            f"turbine {turbine!r}: the OEDB turbine search downloads its data and is not "
            "ported; pass a registry name, a Path to a turbine file or a dict")
    if isinstance(turbine, (str, Path)):
        raw = load_yaml(_resolve(turbine, windturbines, "turbine"))
        conf = dict(V=np.array(raw["V"], dtype=float),
                    POW=np.array(raw["POW"], dtype=float),
                    hub_height=raw["HUB_HEIGHT"],
                    P=float(np.max(raw["POW"])))
    else:
        conf = turbine
    return _validate_turbine_config_dict(conf, add_cutout_windspeed)


def windturbine_rated_capacity_per_unit(turbine):
    """Rated power of a turbine [MW]: the largest value of its curve."""
    if isinstance(turbine, (str, Path)):
        turbine = get_windturbineconfig(turbine)
    return turbine["P"]


def windturbine_smooth(turbine, params=None):
    """The power curve convolved with a Gaussian of the wind speed's
    spread over a cell (Andresen et al. 2015): on a 0.1 m/s grid over
    -50..50 m/s, kernel N(Delta_v, sigma) scaled by 0.1, then sampled at
    72 speeds over 0..35 m/s and scaled by ``eta``.  ``params`` (True or
    a dict) may set ``eta`` (0.95), ``Delta_v`` (1.27) and ``sigma``
    (2.29).  Warns when the smoothed turbine yields power at 0 m/s."""
    if params is None or params is True:
        params = {}
    eta = params.get("eta", 0.95)
    Delta_v = params.get("Delta_v", 1.27)
    sigma = params.get("sigma", 2.29)

    def kernel(v0):
        return (1.0 / np.sqrt(2 * np.pi * sigma * sigma)
                * np.exp(-(v0 - Delta_v) ** 2 / (2 * sigma * sigma)))

    velocities_reg = np.linspace(-50.0, 50.0, 1001)
    power_reg = np.interp(velocities_reg, turbine["V"], turbine["POW"])
    # direct convolution on the 0.1 m/s grid
    convolution = 0.1 * np.convolve(power_reg, kernel(velocities_reg), mode="same")
    velocities_new = np.linspace(0.0, 35.0, 72)
    power_new = eta * np.interp(velocities_new, velocities_reg, convolution)

    turbine = dict(turbine)
    turbine["V"], turbine["POW"] = velocities_new, power_new
    turbine["P"] = np.max(power_new)
    if np.any(turbine["POW"][turbine["V"] == 0.0] > 1e-2):
        logger.warning("Oversmoothing detected with parameters eta=%f, Delta_v=%f, "
                       "sigma=%f. Turbine generates energy at 0 m/s wind speeds.",
                       eta, Delta_v, sigma)
    return turbine


def get_solarpanelconfig(panel):
    """A panel config dict from a name (``CSi``, ``CdTe``, ``KANENA``) or a
    path to a YAML file."""
    return load_yaml(_resolve(panel, solarpanels, "panel"))


def get_cspinstallationconfig(installation):
    """A CSP installation config from a name or a path, with its
    efficiency table as three arrays: ``efficiency_altitude`` and
    ``efficiency_azimuth`` (rad, ascending) and ``efficiency_table``
    (altitude x azimuth, p.u.; NaN where the file has no entry)."""
    path = _resolve(installation, cspinstallations, "installation")
    config = load_yaml(path)
    config["path"] = path

    eff = config["efficiency"]
    if isinstance(eff["altitude"], dict):
        # a table stored as {column: {row: value}}
        rows = sorted(eff["altitude"])
        eff = {k: [eff[k][r] for r in rows] for k in ("altitude", "azimuth", "value")}
    alt = np.asarray(eff["altitude"], dtype=float)  # deg
    azi = np.asarray(eff["azimuth"], dtype=float)  # deg
    val = np.asarray(eff["value"], dtype=float)
    alt_u, azi_u = np.unique(alt), np.unique(azi)
    table = np.full((len(alt_u), len(azi_u)), np.nan)
    table[np.searchsorted(alt_u, alt), np.searchsorted(azi_u, azi)] = val
    config["efficiency_altitude"] = np.radians(alt_u)
    config["efficiency_azimuth"] = np.radians(azi_u)
    config["efficiency_table"] = table / 100.0  # % -> p.u.
    return config


def solarpanel_rated_capacity_per_unit(panel):
    """Rated capacity of a panel per unit: its efficiency (Huld) or its
    power at 1000 W/m^2 (Bofinger)."""
    if isinstance(panel, (str, Path)):
        panel = get_solarpanelconfig(panel)
    model = panel.get("model", "huld")
    if model == "huld":
        return panel["efficiency"]
    if model == "bofinger":
        A, B, C = panel["A"], panel["B"], panel["C"]
        return (A + B * 1000.0 + C * np.log(1000.0)) * 1e3
    raise ValueError(model)


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
