"""Capacity bookkeeping on the port: the five cases of
``tests/test_bookkeeping.py``, with the JAX package's results beside them
where it gives one (layouts equal; the per-region capacity within rtol
1e-6, the JAX test's tolerance).  The cutout is the JAX tests' shared
one: synthetic, one day at 0.25 deg, float64."""

import numpy as np
import pandas as pd
import pytest
import torch

import atlite_tpu
from atlite_tpu.gis.geometry import box as jbox
from atlite_tpu_torch import Cutout
from atlite_tpu_torch.gis.geometry import box

torch.set_num_threads(1)

KW = dict(module="synthetic", bounds=(-4, 56, 1.5, 62), time="2013-01-01", dtype="float64")


@pytest.fixture(scope="module")
def pair():
    return (Cutout(device="cpu", **KW).prepare(),
            atlite_tpu.Cutout(path=None, **KW).prepare())


def test_layout_from_capacity_list(pair):
    c, jc = pair
    g = c.grid_desc
    caps = {"x": [g.x[0], g.x[3] + 0.01, g.x[5] - 0.01],
            "y": [g.y[0], g.y[2], g.y[4] + 0.1],
            "Capacity": [1.0, 2.0, 3.0]}
    layout = c.layout_from_capacity_list(caps)
    assert layout.values.sum() == 6.0
    assert layout.values[0, 0] == 1.0
    assert layout.values[2, 3] == 2.0
    assert layout.values[4, 5] == 3.0
    want = jc.layout_from_capacity_list(pd.DataFrame(caps))
    np.testing.assert_array_equal(layout.values, np.asarray(want.values))


def test_capacity_per_region_bookkeeping(pair):
    c, jc = pair
    layout = c.pv(panel="CSi", orientation="latitude_optimal", aggregate_time="mean")
    g = c.grid_desc
    mid_y = g.y[12] - g.dy / 2  # a cell edge: every cell in one region
    b = c.bounds
    shapes = {"lower": box(b[0], b[1], b[2], mid_y), "upper": box(b[0], mid_y, b[2], b[3])}
    production, capacity = c.pv(panel="CSi", orientation="latitude_optimal", layout=layout,
                                shapes=shapes, return_capacity=True, aggregate_time=None)
    lv = layout.values
    lower = np.broadcast_to(g.y[:, None] < mid_y, lv.shape)
    cap_lower = lv[lower].sum()
    np.testing.assert_allclose(capacity.values, [cap_lower, lv.sum() - cap_lower], rtol=1e-6)
    assert np.all(production.values >= 0)
    jlayout = jc.pv(panel="CSi", orientation="latitude_optimal", aggregate_time="mean")
    jshapes = pd.Series({"lower": jbox(b[0], b[1], b[2], mid_y),
                         "upper": jbox(b[0], mid_y, b[2], b[3])})
    _, jcap = jc.pv(panel="CSi", orientation="latitude_optimal", layout=jlayout, shapes=jshapes,
                    return_capacity=True, aggregate_time=None)
    np.testing.assert_allclose(capacity.values, np.asarray(jcap.values), rtol=1e-6)


def test_production_zero_at_midnight(pair):
    c, _ = pair
    production = c.pv(panel="CdTe", orientation="latitude_optimal", layout=c.uniform_layout(),
                      aggregate_time=None)
    assert float(production.values[0, 0]) == 0.0  # 00:00 UTC in January


def test_merge_refuses_different_coordinates():
    a = Cutout(device="cpu", module="synthetic", x=slice(5, 15), y=slice(47, 55),
               time="2013-01-01")
    b = Cutout(device="cpu", module="synthetic", x=slice(-15, -5), y=slice(47, 55),
               time="2013-01-01")
    assert a.grid_desc.shape == b.grid_desc.shape
    with pytest.raises(ValueError, match="different coordinates"):
        a.merge(b)


def test_isel_time_tolerates_scalar_variable(pair):
    cutout, _ = pair
    c = Cutout(device="cpu", data={**cutout.data, "crs_scalar": np.float64(0)},
               grid_desc=cutout.grid_desc, attrs=dict(cutout.attrs),
               var_attrs={**cutout.var_attrs, "crs_scalar": {"dims": ()}})
    sub = c.isel_time(0, 4)
    assert sub.data["crs_scalar"] == 0.0
    assert sub.data["wnd100m"].shape[0] == 4
