"""The port's copied turbine and panel configurations against the JAX
package's YAML-backed ``atlite_tpu.resource``: equal values, exactly."""

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


@pytest.mark.parametrize("getter, name", [(tres.get_windturbineconfig, "Enercon_E82_3000kW"),
                                          (tres.get_solarpanelconfig, "CdTe")])
def test_other_names_raise(getter, name):
    with pytest.raises(KeyError, match="ROADMAP"):
        getter(name)


def test_turbine_dict_is_validated_like_jax():
    conf = {"V": [0, 5, 10, 25], "POW": [0, 1, 3, 3], "hub_height": 100, "P": 3.0}
    got = tres.get_windturbineconfig(dict(conf), add_cutout_windspeed=True)
    want = jres.get_windturbineconfig(dict(conf), add_cutout_windspeed=True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="ascending"):
        tres.get_windturbineconfig({**conf, "V": [0, 10, 5, 25]})
