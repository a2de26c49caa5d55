"""The port's turbine, panel and CSP-installation configurations and its
YAML reader against the JAX package's YAML-backed ``atlite_tpu.resource``
and ``yaml.safe_load``: equal keys, types and values, exactly.  Also the
registries, power-curve smoothing (and its oversmoothing warning), and
``Cutout.wind`` with other turbines, a turbine file by its ``Path`` and
``smooth=`` against the JAX ``wind`` on the same synthetic cutout (JAX with
x64 off; within 1e-5 * max|JAX|)."""

import logging
import warnings

import jax
import numpy as np
import pytest
import torch

import atlite_tpu

from atlite_tpu import resource as jres
from atlite_tpu_torch import resource as tres


@pytest.mark.parametrize("add_cutout_windspeed", [True, False])
def test_windturbine_equals_jax(add_cutout_windspeed):
    got = tres.get_windturbineconfig("Vestas_V112_3MW", add_cutout_windspeed)
    want = jres.get_windturbineconfig("Vestas_V112_3MW", add_cutout_windspeed)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_windturbine_raw_yaml_fields_equal():
    import yaml

    with open(jres.windturbines["Vestas_V112_3MW"]) as f:
        raw = yaml.safe_load(f)
    assert tres.load_yaml(tres.windturbines["Vestas_V112_3MW"]) == raw


def test_solarpanel_equals_jax():
    got, want = tres.get_solarpanelconfig("CSi"), jres.get_solarpanelconfig("CSi")
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}
    assert tres.get_solarpanelconfig("CSi.yaml") == want


def test_configs_are_copies():
    tres.get_solarpanelconfig("CSi")["efficiency"] = 0.5
    assert tres.get_solarpanelconfig("CSi")["efficiency"] == 0.1


@pytest.mark.parametrize("getter, name", [(tres.get_windturbineconfig, "Enercon_E82_3000kW")])
def test_other_names_raise(getter, name):
    """The OEDB search downloads: its names raise; registry names load."""
    with pytest.raises(NotImplementedError, match="OEDB"):
        getter("oedb:" + name)
    assert getter(name)["P"] == jres.get_windturbineconfig(name)["P"]
    with pytest.raises(KeyError, match="available"):
        getter(name + "_XL")


@pytest.mark.parametrize("getter", [tres.get_solarpanelconfig, tres.get_cspinstallationconfig])
def test_unknown_names_raise(getter):
    with pytest.raises(KeyError, match="available"):
        getter("Perovskite_tandem")
    with pytest.raises(KeyError, match="pathlib"):
        getter(3)


# every copied file: the *.yaml ones and the extensionless eno_126_* turbines
COPIED = sorted(p for p in tres.RESOURCE_DIRECTORY.glob("*/*") if p.is_file())
TURBINE_FILES = [p for p in COPIED if p.parent.name == "windturbine"]


def test_every_copied_file_is_the_jax_packages():
    from atlite_tpu.resource import RESOURCE_DIRECTORY

    want = sorted(f"{n}.yaml" for n in ("CSi", "CdTe", "KANENA", "SAM_parabolic_trough",
                                        "SAM_solar_tower", "lossless_installation"))
    want += [p.name for p in (RESOURCE_DIRECTORY / "windturbine").iterdir()]
    assert sorted(p.name for p in COPIED) == sorted(want)
    assert len(TURBINE_FILES) == 31
    for p in COPIED:
        assert p.read_bytes() == (RESOURCE_DIRECTORY / p.parent.name / p.name).read_bytes()
        # one turbine of the JAX package is a synthesized curve, which says so
        assert p.read_text().startswith(("# Data: Contributors to atlite", "# Nordex_N131_3000kW:"))


def same(got, want):
    """Equal values of equal types, recursively."""
    assert type(got) is type(want), (got, want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    else:
        assert got == want or (got != got and want != want), (got, want)


@pytest.mark.parametrize("path", COPIED,
                         ids=lambda p: p.stem if p.suffix == ".yaml" else p.name)
def test_reader_equals_safe_load(path):
    import yaml

    with open(path) as f:
        want = yaml.safe_load(f)
    same(tres.load_yaml(path), want)


SUBSET = """\
# a comment
name: lossless   # trailing comment
source: None
flag: yes
off_flag: Off
nothing:
tilde: ~
null_word: null
count: 1000
neg: -7
under: 1_000
zero: 0
fl: 5.0e-06
fl2: -2.3e-05
fl3: .5
fl4: 3.
no_sign_exp: 1.0e5
inf: -.inf
nan: .NaN
url: http://www.example.com/a-b/c.pdf
quoted: 'it''s'
dquoted: "plain"
empty_list: []
nested:
  inner: [0, 5.5, x, 10]
  deeper:
    leaf: 1
after: 2
"""


def test_reader_subset_equals_safe_load(tmp_path):
    import yaml

    p = tmp_path / "subset.yaml"
    p.write_text(SUBSET)
    same(tres.load_yaml(p), yaml.safe_load(SUBSET))
    for bad in ("a: 0x1f\n", "a: 017\n", "a: 2001-12-14\n", "a: &x 1\n", "a: 1:30\n",
                "a:\n    b: 1\n  c: 2\n", "a: [1, 2\n"):
        p.write_text(bad)
        with pytest.raises(ValueError):
            tres.load_yaml(p)


@pytest.mark.parametrize("name", ["CSi", "CdTe", "KANENA"])
def test_solarpanels_equal_jax(name):
    got, want = tres.get_solarpanelconfig(name), jres.get_solarpanelconfig(name)
    same(got, want)
    assert tres.solarpanel_rated_capacity_per_unit(name) == \
        jres.solarpanel_rated_capacity_per_unit(name)


@pytest.mark.parametrize("name", ["SAM_parabolic_trough", "SAM_solar_tower",
                                  "lossless_installation"])
def test_cspinstallationconfig_equals_jax(name):
    got, want = tres.get_cspinstallationconfig(name), jres.get_cspinstallationconfig(name)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        elif k == "path":
            assert got[k].name == want[k].name
        else:
            same(got[k], want[k])
    assert got["technology"] == want["technology"]
    assert tres.get_cspinstallationconfig(got["path"])["name"] == got["name"]


def test_turbine_dict_is_validated_like_jax():
    conf = {"V": [0, 5, 10, 25], "POW": [0, 1, 3, 3], "hub_height": 100, "P": 3.0}
    got = tres.get_windturbineconfig(dict(conf), add_cutout_windspeed=True)
    want = jres.get_windturbineconfig(dict(conf), add_cutout_windspeed=True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="ascending"):
        tres.get_windturbineconfig({**conf, "V": [0, 10, 5, 25]})


def test_registries_equal_jax():
    for name in ("windturbines", "solarpanels", "cspinstallations"):
        got, want = getattr(tres, name), getattr(jres, name)
        assert isinstance(got, tres.arrowdict) and list(got) == list(want)
        assert all(got[k].name == want[k].name for k in want)
    assert len(tres.windturbines) == 28
    assert tres.windturbines.Vestas_V112_3MW == tres.windturbines["Vestas_V112_3MW"]
    with pytest.raises(AttributeError):
        tres.windturbines.Perovskite


@pytest.mark.parametrize("add_cutout_windspeed", [True, False])
@pytest.mark.parametrize("path", TURBINE_FILES, ids=lambda p: p.name)
def test_every_turbine_equals_jax(path, add_cutout_windspeed):
    """Each registry name, or each file by its Path (the eno_126_* files
    are reached only so), gives the JAX config; so does its rated power."""
    name = path.stem if path.suffix == ".yaml" else path
    jname = name if isinstance(name, str) else jres.WINDTURBINE_DIRECTORY / path.name
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tres.get_windturbineconfig(name, add_cutout_windspeed)
        want = jres.get_windturbineconfig(jname, add_cutout_windspeed)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert tres.windturbine_rated_capacity_per_unit(name) == \
        jres.windturbine_rated_capacity_per_unit(jname)


SMOOTH = {"true": True, "none": None, "dict": {"eta": 0.9, "Delta_v": 0.8, "sigma": 1.7},
          "partial_dict": {"sigma": 3.1}}


@pytest.mark.parametrize("params", sorted(SMOOTH))
@pytest.mark.parametrize("name", ["Vestas_V112_3MW", "Enercon_E126_7500kW",
                                  "NREL_ReferenceTurbine_2020ATB_5.5MW"])
def test_windturbine_smooth_equals_jax(name, params):
    got = tres.windturbine_smooth(tres.get_windturbineconfig(name), SMOOTH[params])
    want = jres.windturbine_smooth(jres.get_windturbineconfig(name), SMOOTH[params])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["V"].shape == (72,)


def test_oversmoothing_warns_like_jax(caplog):
    conf = tres.get_windturbineconfig("Vestas_V112_3MW")
    wide = {"eta": 1.0, "Delta_v": -6.0, "sigma": 4.0}
    with caplog.at_level(logging.WARNING):
        tres.windturbine_smooth(conf, wide)
        jres.windturbine_smooth(jres.get_windturbineconfig("Vestas_V112_3MW"), wide)
    msgs = [r.getMessage() for r in caplog.records if "Oversmoothing" in r.getMessage()]
    assert len(msgs) == 2 and msgs[0] == msgs[1]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        tres.windturbine_smooth(conf, True)
    assert not [r for r in caplog.records if "Oversmoothing" in r.getMessage()]


WIND_CUTOUT = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 61), time="2013-01-01")


@pytest.fixture(scope="module")
def wind_pair():
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **WIND_CUTOUT).prepare(features=["wind"])
    from atlite_tpu_torch import Cutout

    return jc, Cutout(device="cpu", **WIND_CUTOUT).prepare(features=["wind"])


WIND_CASES = {
    "enercon_e126": dict(turbine="Enercon_E126_7500kW"),
    "nrel_5.5mw": dict(turbine="NREL_ReferenceTurbine_2020ATB_5.5MW"),
    "eno_126_4_by_path": dict(turbine="eno_126_4"),
    "nordex_smooth_true": dict(turbine="Nordex_N131_3000kW", smooth=True),
    "vestas_smooth_dict": dict(turbine="Vestas_V112_3MW", smooth={"sigma": 1.5, "eta": 0.92}),
    "v164_offshore_smooth_true_sum": dict(turbine="Vestas_V164_7MW_offshore", smooth=True,
                                          aggregate_time="sum"),
}


@pytest.mark.parametrize("case", sorted(WIND_CASES))
def test_wind_turbines_and_smoothing_equal_jax(wind_pair, case):
    jc, tc = wind_pair
    kw = {"aggregate_time": None, **WIND_CASES[case]}
    if kw["turbine"].startswith("eno_"):
        jkw = dict(kw, turbine=jres.WINDTURBINE_DIRECTORY / kw["turbine"])
        kw["turbine"] = tres.WINDTURBINE_DIRECTORY / kw["turbine"]
    else:
        jkw = kw
    C = tc.shape[0] * tc.shape[1]
    m = np.random.default_rng(0).random((4, C)) * (np.random.default_rng(1).random((4, C)) < 0.4)
    for extra in ({}, {"matrix": m}):
        with jax.enable_x64(False):
            want = np.asarray(jc.wind(**jkw, **extra).values)
        got = tc.wind(**kw, **extra).values
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        assert np.abs(want).max() > 0
    torch.set_num_threads(1)


def mask_sum_power_curve(wind_speed, V, POW, P):
    """The power curve as a masked sum over segments, as the JAX package
    writes it: the reference for the port's one-gather form."""
    from atlite_tpu_torch.physics import wind as twind

    POWn = POW / P
    left, right, start, slope = twind.curve_segments(V, POWn)
    x = wind_speed[..., None]
    out = torch.where((x >= left) & (x < right), start + (x - left) * slope, 0.0).sum(-1)
    out = (out + torch.where(wind_speed < V[0], POWn[0], 0.0)
           + torch.where(wind_speed >= V[-1], POWn[-1], 0.0))
    return torch.where(torch.isnan(wind_speed), torch.nan, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("smooth", [False, True])
def test_power_curve_gather_equals_the_masked_sum(smooth, dtype):
    """Every registry turbine, smoothed or not: the same bits on random
    speeds, on every knot and an ulp either side of it, NaN, and past the
    cut-out, duplicated knots included."""
    from atlite_tpu_torch.physics import wind as twind

    rng = np.random.default_rng(14)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in tres.windturbines:
            conf = tres.get_windturbineconfig(name)
            if smooth:
                conf = tres.windturbine_smooth(conf)
            V, POW = twind.simplify_power_curve(conf["V"], conf["POW"])
            Vt, Pt = torch.tensor(V, dtype=dtype), torch.tensor(POW, dtype=dtype)
            knots = Vt.numpy()  # in the dtype: its ulps
            x = torch.tensor(np.r_[rng.uniform(-1.0, 40.0, 3000).astype(knots.dtype), knots,
                                   np.nextafter(knots, knots.dtype.type(np.inf)),
                                   np.nextafter(knots, knots.dtype.type(-np.inf)),
                                   np.nan, 35.0], dtype=dtype)
            got = twind.power_curve(x, Vt, Pt, float(conf["P"]))
            want = mask_sum_power_curve(x, Vt, Pt, float(conf["P"]))
            assert torch.equal(torch.isnan(got), torch.isnan(want)), name
            ok = ~torch.isnan(want)
            assert torch.equal(got[ok], want[ok]), name
