"""The port's DataArray against the JAX package's: the 18 cases of
``tests/test_dataarray.py``, each on the same inputs through both
classes, with the port's values as numpy arrays and as CPU tensors
(elementwise methods, operators and selection keep a tensor a tensor on
its device); and a hypothesis test of ``sel`` on ascending and descending
float coordinates (label slices with steps of +-1 and +-2, scalars,
``method="nearest"``, label lists) and on hourly stamps with partial
labels ("2013", "2013-01", "2013-01-02", "2013-01-02 05:00"): the port
must pick the positions JAX picks, or raise the same error.

Tolerance: exact (the same numpy or float64 operations on both sides).
"""

import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from atlite_tpu.dataarray import DataArray as J
from atlite_tpu_torch.dataarray import DataArray

torch.set_num_threads(1)

KINDS = ["numpy", "tensor"]


def make(kind, values, **kw):
    """(JAX DataArray, port DataArray) of the same values and labels."""
    values = np.asarray(values)
    tv = torch.as_tensor(values) if kind == "tensor" else values
    return J(values, **kw), DataArray(tv, **kw)


def check(got, want, kind=None):
    """Same dims, coords and values; a tensor stays a tensor."""
    assert isinstance(got, DataArray)
    assert got.dims == tuple(want.dims)
    if kind == "tensor":
        assert isinstance(got.values, torch.Tensor)
    for d, c in want.coords.items():
        np.testing.assert_array_equal(got.coords[d], np.asarray(c))
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(want.values))


@pytest.fixture(params=KINDS)
def das(request):
    kw = dict(coords={"time": pd.date_range("2013-01-01", periods=2, freq="h"),
                      "y": [50.0, 50.5, 51.0], "x": [1.0, 1.5, 2.0, 2.5]},
              dims=("time", "y", "x"), name="t")
    return (*make(request.param, np.arange(24.0).reshape(2, 3, 4), **kw), request.param)


def test_basic_props(das):
    j, t, kind = das
    assert t.shape == j.shape == (2, 3, 4)
    assert t.sizes == j.sizes and t.ndim == j.ndim == 3 and len(t) == len(j) == 2
    assert t.get_axis_num("x") == j.get_axis_num("x") == 2
    assert str(t.dtype).endswith(str(j.dtype))
    r = t.rename("u").assign_attrs(units="m")
    assert r.name == "u" and r.attrs == {"units": "m"} and t.name == "t"


def test_isel_sel(das):
    j, t, kind = das
    check(t.isel(time=0), j.isel(time=0), kind)
    check(t.sel(x=slice(1.5, 2.0)), j.sel(x=slice(1.5, 2.0)), kind)
    s3 = t.sel(x=1.6, method="nearest")
    check(s3, j.sel(x=1.6, method="nearest"), kind)
    np.testing.assert_array_equal(s3.to_numpy(), t.to_numpy()[:, :, 1])
    check(t.sel(y=50.5), j.sel(y=50.5), kind)
    check(t.sel(x=[2.5, 1.0]), j.sel(x=[2.5, 1.0]), kind)
    with pytest.raises(KeyError):
        t.sel(x=[1.0, 7.0])
    with pytest.raises(KeyError):
        t.sel(y=50.2)


def test_reductions(das):
    j, t, _ = das
    check(t.mean("time"), j.mean("time"))
    for fn in ("sum", "mean", "min", "max"):
        check(getattr(t, fn)("y"), getattr(j, fn)("y"))
        assert getattr(t, fn)() == getattr(j, fn)()
    assert t.quantile(0.3) == j.quantile(0.3)
    np.testing.assert_array_equal(t.quantile([0.1, 0.9]), j.quantile([0.1, 0.9]))


def test_arith_broadcasting(das):
    j, t, kind = das
    jo, to = make(kind, np.array([1.0, 2.0, 3.0]), coords={"y": j.coords["y"]}, dims=("y",))
    check(t * to, j * jo, kind)
    check(to * t, jo * j, kind)
    check(2.0 - t, 2.0 - j, kind)
    check((t + 1.0) / (t + 1.0), (j + 1.0) / (j + 1.0), kind)
    check(t ** 2 - -t, j ** 2 - -j, kind)
    for op in ("__ge__", "__le__", "__gt__", "__lt__", "__eq__", "__ne__"):
        check(getattr(t, op)(5.0), getattr(j, op)(5.0), kind)
    # a numpy operand on tensor values, and the reverse, give the values' kind
    check(t * np.arange(4.0), j * np.arange(4.0), kind)


def test_where_clip_fillna(das):
    j, t, kind = das
    out, jout = t.where(t > 5), j.where(j > 5)
    check(out, jout, kind)
    assert np.isnan(out.to_numpy()).sum() == 6
    check(out.fillna(-1.0), jout.fillna(-1.0), kind)
    check(t.clip(min=3, max=10), j.clip(min=3, max=10), kind)
    check(t.clip(max=10), j.clip(max=10), kind)


def test_rolling_mean():
    for kind in KINDS:
        j, t = make(kind, np.arange(6.0), coords={"time": range(6)}, dims=("time",))
        check(t.rolling_mean("time", 3, min_periods=1), j.rolling_mean("time", 3, min_periods=1))
        np.testing.assert_allclose(t.rolling_mean("time", 3).values, [0, 0.5, 1, 2, 3, 4])


def test_transpose_to_pandas(das):
    j, t, kind = das
    tt, jt = t.isel(x=0).transpose("y", "time"), j.isel(x=0).transpose("y", "time")
    check(tt, jt, kind)
    # the stamps compare as values: pandas keeps the JAX ones at its own unit
    pd.testing.assert_frame_equal(tt.to_pandas(), jt.to_pandas(), check_column_type=False,
                                  check_freq=False)
    pd.testing.assert_series_equal(t.isel(x=0, y=1).to_pandas(), j.isel(x=0, y=1).to_pandas(),
                                   check_index_type=False, check_freq=False)
    for da in (t, j):
        with pytest.raises(ValueError):
            da.to_pandas()


def test_coord_length_validation():
    for cls in (J, DataArray):
        with pytest.raises(ValueError):
            cls(np.zeros((2, 2)), coords={"a": [1], "b": [1, 2]}, dims=("a", "b"))
    with pytest.raises(ValueError):
        DataArray(torch.zeros((2, 2)), coords={"a": [1], "b": [1, 2]}, dims=("a", "b"))


def test_plot_smoke(das, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    j, t, _ = das
    m = t.isel(time=0).plot()
    np.testing.assert_array_equal(m.get_array(), j.isel(time=0).plot().get_array())
    plt.savefig(tmp_path / "f.png")
    plt.close("all")
    line = t.isel(time=0, y=0).plot()
    np.testing.assert_array_equal(line.get_ydata(), j.isel(time=0, y=0).plot().get_ydata())
    plt.close("all")
    with pytest.raises(ValueError):
        t.plot()


@pytest.mark.parametrize("kind", KINDS)
def test_sel_multiple_dims_outer_selection(kind):
    kw = dict(coords={"time": np.arange(2), "y": np.array([50.0, 51, 52]),
                      "x": np.array([1.0, 2, 3, 4])}, dims=("time", "y", "x"))
    j, t = make(kind, np.arange(24.0).reshape(2, 3, 4), **kw)
    for sel in (dict(y=slice(50, 52), x=slice(1, 2)), dict(y=slice(50, 51), x=slice(1, 2))):
        check(t.sel(**sel), j.sel(**sel), kind)
    r3 = t.isel(time=0, x=[1, 2])
    check(r3, j.isel(time=0, x=[1, 2]), kind)
    assert r3.shape == (3, 2) and r3.dims == ("y", "x")
    check(t.isel(x=[-1, 0], y=np.array([True, False, True])),
          j.isel(x=[-1, 0], y=np.array([True, False, True])), kind)
    check(t.isel(x=slice(None, None, -2)), j.isel(x=slice(None, None, -2)), kind)


@pytest.mark.parametrize("kind", KINDS)
def test_binop_refuses_misaligned_coords(kind):
    ja, ta = make(kind, np.array([1.0, 2, 3]), coords={"x": [1, 2, 3]}, dims=("x",))
    jb, tb = make(kind, np.array([10.0, 20, 30]), coords={"x": [3, 2, 1]}, dims=("x",))
    for a, b in ((ja, jb), (ta, tb)):
        with pytest.raises(ValueError, match="align"):
            a + b
    jc, tc = make(kind, np.array([10.0, 20, 30]), coords={"x": [1, 2, 3]}, dims=("x",))
    check(ta + tc, ja + jc, kind)
    np.testing.assert_allclose((ta + tc).to_numpy(), [11, 22, 33])


@pytest.mark.parametrize("kind", KINDS)
def test_sel_string_datetime_labels(kind):
    times = pd.date_range("2013-01-01", periods=72, freq="h").values
    j, t = make(kind, np.arange(72.0), coords={"time": times}, dims=("time",))
    for label in (slice("2013-01-01", "2013-01-02"), "2013-01-02",
                  slice("2013-01-02 03:00", None), np.datetime64("2013-01-01T05:00"),
                  "2013-01-01 05:00", "2013-01", "2013"):
        check(t.sel(time=label), j.sel(time=label), kind)
    assert len(t.sel(time=slice("2013-01-01", "2013-01-02")).values) == 48
    assert len(t.sel(time="2013-01-02").values) == 24
    s4 = t.sel(time=np.datetime64("2013-01-01T05:00"))
    assert s4.ndim == 0 and float(s4.values) == 5.0
    for da in (t, j):
        with pytest.raises(KeyError):
            da.sel(time="2013-02")


@pytest.mark.parametrize("kind", KINDS)
def test_sel_datetime_slice_step(kind):
    times = pd.date_range("2013-01-01", periods=48, freq="h").values
    j, t = make(kind, np.arange(48.0), coords={"time": times}, dims=("time",))
    s = t.sel(time=slice("2013-01-01", "2013-01-02", 3))
    check(s, j.sel(time=slice("2013-01-01", "2013-01-02", 3)), kind)
    assert len(s.values) == 16


@pytest.mark.parametrize("kind", KINDS)
def test_sel_numeric_slice_step(kind):
    j, t = make(kind, np.arange(20.0), coords={"x": np.arange(20) * 0.5}, dims=("x",))
    check(t.sel(x=slice(1.0, 8.0, 3)), j.sel(x=slice(1.0, 8.0, 3)), kind)
    np.testing.assert_array_equal(t.sel(x=slice(1.0, 8.0, 3)).to_numpy(), np.arange(2, 17, 3))


@pytest.mark.parametrize("kind", KINDS)
def test_sel_negative_slice_step_loc_semantics(kind):
    j, t = make(kind, np.arange(20.0), coords={"x": np.arange(20.0)}, dims=("x",))
    s = pd.Series(np.arange(20.0), index=np.arange(20.0))
    for sl in (slice(8.0, None, -1), slice(None, 8.0, -1), slice(12.0, 3.0, -2),
               slice(3.0, 15.0, 4), slice(3.0, 12.0, -2)):
        check(t.sel(x=sl), j.sel(x=sl), kind)
        np.testing.assert_array_equal(t.sel(x=sl).to_numpy(), s.loc[sl].values)
    times = pd.date_range("2013-01-01", periods=48, freq="h")
    jt, tt = make(kind, np.arange(48.0), coords={"time": times.values}, dims=("time",))
    st_ = pd.Series(np.arange(48.0), index=times)
    for sl in (slice("2013-01-02", None, -1), slice(None, None, -6),
               slice("2013-01-02 10:00", "2013-01-01 05:00", -3)):
        check(tt.sel(time=sl), jt.sel(time=sl), kind)
        np.testing.assert_array_equal(tt.sel(time=sl).to_numpy(), st_.loc[sl].values)


@pytest.mark.parametrize("kind", KINDS)
def test_where_name_broadcasts_and_eq_elementwise(kind):
    kw = dict(coords={"time": np.array([0, 1]), "spatial": np.array([10, 20])},
              dims=("time", "spatial"))
    j, t = make(kind, np.arange(4.0).reshape(2, 2), **kw)
    jc, tc = make(kind, np.array([True, False]), coords={"time": np.array([0, 1])},
                  dims=("time",))
    check(t.where(tc, 0.0), j.where(jc, 0.0), kind)
    np.testing.assert_array_equal(t.where(tc, 0.0).to_numpy(), [[0.0, 1.0], [0.0, 0.0]])
    _, bad = make(kind, np.array([True, False]), coords={"time": np.array([5, 6])},
                  dims=("time",))
    with pytest.raises(ValueError, match="coordinate"):
        t.where(bad, 0.0)
    eq = t == 1.0
    check(eq, j == 1.0, kind)
    with pytest.raises(TypeError):
        hash(t)
    ji, ti = make(kind, np.arange(3), coords={"x": np.arange(3)}, dims=("x",))
    check(ti.fillna(0), ji.fillna(0), kind)
    # a DataArray fill value broadcasts by name
    _, tn = make(kind, np.array([[np.nan, 1.0], [2.0, np.nan]]), **kw)
    _, fill = make(kind, np.array([7.0, 8.0]), coords={"spatial": np.array([10, 20])},
                   dims=("spatial",))
    np.testing.assert_array_equal(tn.fillna(fill).to_numpy(), [[7.0, 1.0], [2.0, 8.0]])


@pytest.mark.parametrize("kind", KINDS)
def test_sel_descending_index_slices(kind):
    coord = np.arange(10.0)[::-1]
    j, t = make(kind, np.arange(10.0), coords={"x": coord}, dims=("x",))
    s = pd.Series(np.arange(10.0), index=coord)
    for sl in (slice(8.0, 3.0), slice(None, 4.0), slice(7.0, None), slice(3.0, 8.0)):
        check(t.sel(x=sl), j.sel(x=sl), kind)
        np.testing.assert_array_equal(t.sel(x=sl).to_numpy(), s.loc[sl].values)


@pytest.mark.parametrize("kind", KINDS)
def test_sel_misordered_positive_slice_empty(kind):
    j, t = make(kind, np.arange(10.0), coords={"x": np.arange(10.0)}, dims=("x",))
    check(t.sel(x=slice(8.0, 3.0)), j.sel(x=slice(8.0, 3.0)), kind)
    assert len(t.sel(x=slice(8.0, 3.0)).values) == 0


# ---- hypothesis: the port's sel picks JAX's positions ---------------------
def positions(da, **indexer):
    """The positions ``sel`` picks (values are 0..n-1), or the error."""
    try:
        return np.asarray(da.sel(**indexer).to_numpy() if isinstance(da, DataArray)
                          else da.sel(**indexer).values).tolist()
    except (KeyError, ValueError) as exc:
        return type(exc).__name__


labels = st.integers(-24, 24).map(lambda i: i * 0.5)
steps = st.sampled_from([None, 1, -1, 2, -2])
maybe = st.one_of(st.none(), labels)


@settings(max_examples=300, deadline=None, database=None)
@given(coord=st.lists(st.integers(-20, 20), min_size=1, max_size=12, unique=True),
       descending=st.booleans(), start=maybe, stop=maybe, step=steps, scalar=labels,
       picks=st.lists(labels, min_size=1, max_size=3), tensor=st.booleans())
def test_sel_float_coords_like_jax(coord, descending, start, stop, step, scalar, picks, tensor):
    vals = np.sort(np.asarray(coord, dtype=float) * 0.5)
    if descending:
        vals = vals[::-1].copy()
    n = len(vals)
    j = J(np.arange(n), coords={"x": vals}, dims=("x",))
    t = DataArray(torch.arange(n) if tensor else np.arange(n), coords={"x": vals}, dims=("x",))
    for ind in (dict(x=slice(start, stop, step)), dict(x=scalar),
                dict(x=scalar, method="nearest"), dict(x=picks),
                dict(x=picks, method="nearest")):
        assert positions(t, **ind) == positions(j, **ind), ind


partial = st.sampled_from(["2013", "2013-01", "2013-01-02", "2013-01-02 05:00", "2013-01-03",
                           "2013-01-01 23:00", "2012-12", "2013-02", "2013-01-04 02:00"])


@settings(max_examples=200, deadline=None, database=None)
@given(start=st.one_of(st.none(), partial), stop=st.one_of(st.none(), partial), step=steps,
       label=partial, periods=st.integers(1, 90), freq=st.sampled_from(["h", "3h", "D"]))
def test_sel_partial_time_labels_like_jax(start, stop, step, label, periods, freq):
    times = pd.date_range("2013-01-01", periods=periods, freq=freq).values
    j = J(np.arange(periods), coords={"time": times}, dims=("time",))
    t = DataArray(np.arange(periods), coords={"time": times}, dims=("time",))
    for ind in (dict(time=slice(start, stop, step)), dict(time=label),
                dict(time=label, method="nearest")):
        assert positions(t, **ind) == positions(j, **ind), ind
