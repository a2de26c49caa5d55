"""``Cutout.hydro`` and ``Cutout.line_rating`` with their geometry: the
port against the JAX package, on the CPU.

Hydro, on the fixtures of tests/test_hydro.py (a three-basin cascade) and
on a random basin tree over a grid of boxes: the upstream search, the
basins, their areas and travel hours, the missing-column and no-basin
errors, and the inflow, with plants and basins as pandas DataFrames and as
dicts of columns.  Line rating, on the cases of tests/test_line_rating.py
(end to end, without stored solar position, a line that meets no cell,
chunked against single, unknown parameters) and on random polylines.

Tolerances: the inflow and the ratings within 1e-5 * max|JAX|, JAX with
x64 off, NaN masks identical; areas within 1e-12 relative (both float64
host code); basins, upstream lists and travel hours exactly; chunked
ratings against single within rtol 1e-6, as the JAX test holds them.
"""

import warnings

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import atlite_tpu
from atlite_tpu.gis.geometry import LineString as JLineString
from atlite_tpu.gis.geometry import box as jbox
from atlite_tpu.physics import hydro as jhydro
from atlite_tpu_torch import Cutout
from atlite_tpu_torch.gis.geometry import LineString, box
from atlite_tpu_torch.physics import hydro as thydro

torch.set_num_threads(1)

WEEK = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 61),
            time=slice("2013-01-01", "2013-01-07"))


@pytest.fixture(scope="module")
def pair():
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **WEEK).prepare()
    return jc, Cutout(device="cpu", **WEEK).prepare()


def cascade(jax_side):
    """tests/test_hydro.py's three basins: 30 -> 20 -> 10."""
    b = jbox if jax_side else box
    return pd.DataFrame({
        "HYBAS_ID": [10, 20, 30], "NEXT_DOWN": [0, 10, 20], "DIST_MAIN": [100.0, 150.0, 230.0],
        "geometry": [b(-3.0, 56.5, -1.5, 58.0), b(-1.5, 56.5, 0.0, 58.0), b(0.0, 56.5, 1.5, 58.0)],
    })


PLANTS = pd.DataFrame({"lon": [-2.25], "lat": [57.25]}, index=["plant0"])


def tree(jax_side, seed=0, ny=4, nx=5):
    """A random basin tree over ny x nx boxes: each basin drains into a
    neighbour nearer the outlet (the south-west corner, NEXT_DOWN 0), and
    DIST_MAIN grows by 20-90 km a step; ids are shuffled."""
    rng = np.random.default_rng(seed)
    b = jbox if jax_side else box
    x = np.linspace(-3.8, 1.3, nx + 1)
    y = np.linspace(56.1, 60.8, ny + 1)
    ids = rng.permutation(np.arange(100, 100 + ny * nx))
    hid = {(j, i): int(ids[j * nx + i]) for j in range(ny) for i in range(nx)}
    down, dist = {}, {}
    for s in range(ny + nx - 1):
        for j in range(ny):
            i = s - j
            if not 0 <= i < nx:
                continue
            if (j, i) == (0, 0):
                down[hid[j, i]], dist[hid[j, i]] = 0, 0.0
                continue
            nb = [(j - 1, i)] * (j > 0) + [(j, i - 1)] * (i > 0)
            to = nb[rng.integers(len(nb))]
            down[hid[j, i]] = hid[to]
            dist[hid[j, i]] = dist[hid[to]] + rng.uniform(20.0, 90.0)
    keys = [hid[j, i] for j in range(ny) for i in range(nx)]
    return pd.DataFrame({"HYBAS_ID": keys, "NEXT_DOWN": [down[k] for k in keys],
                         "DIST_MAIN": [dist[k] for k in keys],
                         "geometry": [b(x[i], y[j], x[i + 1], y[j + 1])
                                      for j in range(ny) for i in range(nx)]})


def tree_plants(seed=1, n=6):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"lon": rng.uniform(-3.7, 1.2, n), "lat": rng.uniform(56.2, 60.7, n)},
                        index=[f"p{i}" for i in range(n)])


def as_dict(df):
    return {k: df[k].tolist() for k in df}


@pytest.mark.parametrize("kind", ["dataframe", "dict"])
def test_determine_basins_equals_jax(kind):
    for basins_df, plants in ((cascade, PLANTS), (tree, tree_plants())):
        want = jhydro.determine_basins(plants, basins_df(True))
        tb, tp = basins_df(False), plants
        if kind == "dict":
            tb, tp = as_dict(tb), as_dict(tp)
        got = thydro.determine_basins(tp, tb)
        assert got.plants["hid"] == want.plants["hid"].tolist()
        assert got.plants["upstream"] == want.plants["upstream"].tolist()
        assert list(got.shapes) == list(want.shapes.index)
        assert got.meta["DIST_MAIN"] == want.meta["DIST_MAIN"].to_dict()
        labels = np.asarray(got.plants["index"])
        np.testing.assert_array_equal(labels, plants.index if kind == "dataframe"
                                      else np.arange(len(plants)))
        np.testing.assert_allclose(thydro.basin_areas_m2(got), jhydro.basin_areas_m2(want),
                                   rtol=1e-12)
        for h, ups in zip(got.plants["hid"], got.plants["upstream"]):
            np.testing.assert_array_equal(
                thydro.travel_hours(got.meta["DIST_MAIN"], h, ups, 1.3),
                jhydro.travel_hours(want.meta["DIST_MAIN"], h, ups, 1.3))


def test_upstream_bfs_equals_jax():
    for frame in (cascade(False), tree(False, seed=2)):
        nd = frame.set_index("HYBAS_ID")["NEXT_DOWN"]
        for hid in nd.index:
            want = jhydro.find_upstream_basins(nd, hid)
            assert thydro.find_upstream_basins(nd, hid) == want
            assert thydro.find_upstream_basins(nd.to_dict(), hid) == want
    assert thydro.find_upstream_basins(cascade(False).set_index("HYBAS_ID")["NEXT_DOWN"],
                                       10) == [10, 20, 30]


def test_basin_errors():
    frame = cascade(False)
    with pytest.raises(AssertionError, match="DIST_MAIN"):
        thydro.determine_basins(PLANTS, frame.drop(columns="DIST_MAIN"))
    with pytest.raises(AssertionError, match="DIST_MAIN"):
        jhydro.determine_basins(PLANTS, cascade(True).drop(columns="DIST_MAIN"))
    far = pd.DataFrame({"lon": [40.0], "lat": [10.0]})
    with pytest.raises(ValueError, match="No basin found"):
        thydro.determine_basins(far, frame)


def close(got, want):
    w = np.asarray(want.values)
    assert got.dims == want.dims and got.values.shape == w.shape
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(w))
    ok = ~np.isnan(w)
    assert np.abs(got.values[ok] - w[ok]).max() <= 1e-5 * np.abs(w[ok]).max()


HYDRO_CASES = {
    "cascade": (cascade, PLANTS, {}),
    "cascade_height_flowspeed": (cascade, PLANTS, dict(weight_with_height=True, flowspeed=2.7)),
    "tree": (tree, tree_plants(), {}),
    "tree_dicts": (tree, tree_plants(seed=3, n=9), dict(flowspeed=0.6, as_dicts=True)),
}


@pytest.mark.parametrize("case", sorted(HYDRO_CASES))
def test_hydro_equals_jax(pair, case):
    jc, tc = pair
    basins_df, plants, kw = HYDRO_CASES[case]
    kw = dict(kw)
    dicts = kw.pop("as_dicts", False)
    with jax.enable_x64(False), warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        want = jc.hydro(plants, basins_df(True), **kw)
    tb, tp = basins_df(False), plants
    if dicts:
        tb, tp = as_dict(tb), as_dict(tp)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        got = tc.hydro(tp, tb, **kw)
    assert got.dims == ("plant", "time") and got.values.shape == (len(plants), 7 * 24)
    close(got, want)
    np.testing.assert_array_equal(got.coords["plant"],
                                  np.arange(len(plants)) if dicts else plants.index)
    np.testing.assert_array_equal(got.coords["time"],
                                  np.asarray(want.coords["time"]).astype("datetime64[ns]"))
    assert (got.values >= 0).all() and got.values.max() > 0


def test_hydro_is_the_rolled_basin_runoff(pair):
    """The inflow equals the sum of each basin's runoff, averaged over its
    cells, times its area, rolled by the travel time (tests/test_hydro.py)."""
    _, tc = pair
    frame = cascade(False)
    basins = thydro.determine_basins(PLANTS, frame)
    m = tc.indicatormatrix(basins.shapes).tocsr()
    m = row_normalised(m)
    r = tc.runoff(matrix=m, weight_with_height=False, aggregate_time=None).values
    r = r * thydro.basin_areas_m2(basins)[:, None]
    n = thydro.travel_hours(dict(zip(frame.HYBAS_ID, frame.DIST_MAIN)), 10, [10, 20, 30], 1)
    np.testing.assert_array_equal(n, [0, 14, 36])
    want = sum(np.roll(r[i], n[i]) for i in range(3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        got = tc.hydro(PLANTS, frame, flowspeed=1).values[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def row_normalised(m):
    s = np.asarray(m.sum(axis=1)).ravel()
    return m.multiply(1.0 / s[:, None]).tocsr()


def lines(jax_side):
    L = JLineString if jax_side else LineString
    return pd.Series({
        "l1": L([(-3.5, 57.0), (0.5, 57.0)]),   # W-E
        "l2": L([(-2.0, 56.5), (-2.0, 61.0)]),  # S-N
        "l3": L([(-3.0, 58.5), (1.0, 60.5)]),
    })


def random_polylines(jax_side, n=25, seed=4):
    rng = np.random.default_rng(seed)
    L = JLineString if jax_side else LineString
    out = []
    for i in range(n):
        start = rng.uniform([-4.2, 55.8], [1.7, 61.2])
        pts = np.vstack([start, start + np.cumsum(rng.normal(0, 0.5, (1 + i % 4, 2)), axis=0)])
        out.append(L(pts))
    return out


def rate(c, shapes, **kw):
    with jax.enable_x64(False):
        return c.line_rating(shapes, **kw)


LR_CASES = {
    "series": (lines, dict(line_resistance=1e-4)),
    # all four parameters, in the order the JAX package's column check needs
    "random_list": (random_polylines, dict(line_resistance=1.2e-4, D=0.025, Ts=363,
                                           epsilon=0.8, alpha=0.7)),
    "per_line_values": (lines, dict(line_resistance=np.array([1e-4, 5e-5, 2e-4]),
                                    D=np.array([0.028, 0.03, 0.02]))),
    "chunked": (random_polylines, dict(line_resistance=1e-4, _chunk_hours=13)),
}


@pytest.mark.parametrize("case", sorted(LR_CASES))
def test_line_rating_equals_jax(pair, case):
    jc, tc = pair
    make, kw = LR_CASES[case]
    want = rate(jc, make(True), **kw)
    got = tc.line_rating(make(False), **kw)
    assert got.dims == ("name", "time") and got.attrs == {"units": "A"}
    close(got, want)
    np.testing.assert_array_equal(got.coords["name"], np.asarray(want.coords["name"]))
    assert np.isfinite(got.values).any()


def test_line_rating_end_to_end(pair):
    _, tc = pair
    out = tc.line_rating(lines(False)[["l1", "l2"]], line_resistance=1e-4)
    assert out.values.shape == (2, 7 * 24)
    assert np.isfinite(out.values).all() and (out.values > 0).all()
    np.testing.assert_array_equal(out.coords["name"], ["l1", "l2"])


def test_line_rating_without_stored_solar_position():
    kw = dict(module="synthetic", x=slice(-3, 0), y=slice(56, 59), time="2013-06-01")
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **kw).prepare()
        for v in ("solar_altitude", "solar_azimuth"):
            del jc.data[v]
        jc._invalidate()
    tc = Cutout(device="cpu", **kw).prepare()
    for v in ("solar_altitude", "solar_azimuth"):
        del tc.data[v]
    tc._invalidate()
    L = {"l1": ((-2.5, 57.0), (-0.5, 57.0)), "l2": ((-2.8, 56.2), (-0.3, 58.8))}
    want = rate(jc, pd.Series({k: JLineString(v) for k, v in L.items()}), line_resistance=1e-4)
    got = tc.line_rating(pd.Series({k: LineString(v) for k, v in L.items()}),
                         line_resistance=1e-4)
    assert np.isfinite(got.values).all() and (got.values > 0).all()
    close(got, want)


def test_line_rating_no_overlap_is_nan(pair):
    _, tc = pair
    out = tc.line_rating(pd.Series({"far": LineString([(100.0, 10.0), (101.0, 10.0)])}),
                         line_resistance=1e-4)
    assert np.isnan(out.values).all() and out.values.shape == (1, 7 * 24)


def test_line_rating_chunked_equals_single(pair):
    _, tc = pair
    full = tc.line_rating(lines(False), line_resistance=1e-4)
    for hours in (7, 24, 1000):
        chunked = tc.line_rating(lines(False), line_resistance=1e-4, _chunk_hours=hours)
        np.testing.assert_allclose(chunked.values, full.values, rtol=1e-6)


def test_line_rating_parameters(pair):
    jc, tc = pair
    line = [LineString([(-3.0, 57.0), (0.0, 60.0)])]
    with pytest.raises(ValueError, match="Epsilon"):
        tc.line_rating(line, 1e-5, Epsilon=0.9)
    with pytest.raises(ValueError, match="Nan values"):
        tc.line_rating(line, np.nan)
    # one parameter of four given: the JAX package refuses it (its column
    # check depends on their order, ROADMAP section 3); the port takes it
    # as the other three at their defaults
    got = tc.line_rating(line, 1e-4, Ts=350)
    want = rate(jc, [JLineString([(-3.0, 57.0), (0.0, 60.0)])], line_resistance=1e-4,
                D=0.028, Ts=350, epsilon=0.6, alpha=0.6)
    close(got, want)
    with pytest.raises(ValueError, match=r"unexpected line-rating parameters \[\]"):
        rate(jc, [JLineString([(-3.0, 57.0), (0.0, 60.0)])], line_resistance=1e-4, Ts=350)
