"""The port's turbine, panel and CSP-installation configurations and its
YAML reader against the JAX package's YAML-backed ``atlite_tpu.resource``
and ``yaml.safe_load``: equal keys, types and values, exactly."""

import numpy as np
import pytest

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
    assert tres.WINDTURBINES["Vestas_V112_3MW"] == raw


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
    with pytest.raises(KeyError, match="ROADMAP"):
        getter(name)


@pytest.mark.parametrize("getter", [tres.get_solarpanelconfig, tres.get_cspinstallationconfig])
def test_unknown_names_raise(getter):
    with pytest.raises(KeyError, match="available"):
        getter("Perovskite_tandem")
    with pytest.raises(KeyError, match="pathlib"):
        getter(3)


COPIED = sorted((tres.RESOURCE_DIRECTORY).glob("*/*.yaml"))


def test_every_copied_file_is_the_jax_packages():
    from atlite_tpu.resource import RESOURCE_DIRECTORY

    assert sorted(p.name for p in COPIED) == sorted(
        f"{n}.yaml" for n in ("CSi", "CdTe", "KANENA", "SAM_parabolic_trough",
                              "SAM_solar_tower", "lossless_installation"))
    for p in COPIED:
        assert p.read_bytes() == (RESOURCE_DIRECTORY / p.parent.name / p.name).read_bytes()
        assert p.read_text().startswith("# Data: Contributors to atlite")


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


@pytest.mark.parametrize("path", COPIED, ids=lambda p: p.stem)
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
