"""``convert_and_aggregate`` for wind and PV: the port against the JAX
package on the same synthetic cutout, on the CPU, JAX with x64 off.

Covered: resident; streamed with a time axis that is not a multiple of
``time_chunk`` (the tail window slides back); int16-packed against
int16-packed; ``aggregate_time`` None, sum, mean and legacy;
``per_unit``, ``return_capacity`` and ``layout``; a matrix above a
lowered dense limit (the banded route); the time coordinates as
``datetime64[ns]``.

Tolerance: rtol 1e-5, atol 2e-5 (float32 chains and sums in another
order), NaN masks identical.  Packed against packed: the codes are equal,
only the float32 rebuild may round apart, which can flip the PV low-sun
cutoff of an isolated cell-hour (ROADMAP section 3), so the bulk is held
by its 99.9th percentile (1e-5 of the max) and the maximum by 2e-2 of
the max.
"""

import warnings

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

import atlite_tpu
import atlite_tpu.aggregate as jagg
from atlite_tpu.dataarray import DataArray as JDataArray
from atlite_tpu_torch import Cutout, aggregate
from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.ops import bsr_spmm as tbsr

torch.set_num_threads(1)

SMALL = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 62),
             time=slice("2013-01-01", "2013-01-03"))
WIDE = dict(module="synthetic", x=slice(-12, 18), y=slice(35, 60),
            time=slice("2013-06-01", "2013-06-02"))
FEATURES = ["wind", "influx", "temperature"]


def make_pair(kw):
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **kw).prepare(features=FEATURES)
    return jc, Cutout(device="cpu", **kw).prepare(features=FEATURES)


@pytest.fixture(scope="module")
def small():
    jc, tc = make_pair(SMALL)
    C = tc.shape[0] * tc.shape[1]
    m = sp.random(6, C, density=0.3, random_state=1, format="lil", dtype=np.float32)
    m[4] = 0.0  # a bus with no cell
    return jc, tc, m.tocsr()


@pytest.fixture(scope="module")
def wide():
    """101 x 121 cells and 512 rectangular regions: banded below a
    lowered dense limit."""
    jc, tc = make_pair(WIDE)
    g = tc.grid_desc
    ix = np.minimum((np.arange(len(g.x)) * 16) // len(g.x), 15)
    iy = np.minimum((np.arange(len(g.y)) * 32) // len(g.y), 31)
    bus = (iy[:, None] * 16 + ix[None, :]).ravel()
    m = sp.csr_matrix((np.ones(bus.size, np.float32), (bus, np.arange(bus.size))),
                      shape=(512, bus.size))
    return jc, tc, m


def wind(c, **kw):
    return c.wind("Vestas_V112_3MW", **kw)


def pv(c, **kw):
    return c.pv(panel="CSi", orientation="latitude_optimal", **kw)


CONVERTERS = {"wind": wind, "pv": pv}


def both(pair, conv, **kw):
    """(port result, JAX result) of one call."""
    jc, tc = pair[:2]
    with jax.enable_x64(False), warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        want = CONVERTERS[conv](jc, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        got = CONVERTERS[conv](tc, **kw)
    return got, want


def assert_da_close(got, want, rtol=1e-5, atol=2e-5):
    assert isinstance(got.values, np.ndarray)  # results come back to the host
    assert got.dims == want.dims
    assert got.attrs == want.attrs and got.name == want.name
    for d in want.coords:
        g, w = got.coords[d], np.asarray(want.coords[d])
        if w.dtype.kind == "M":
            assert g.dtype == np.dtype("datetime64[ns]")
            w = w.astype("datetime64[ns]")
        np.testing.assert_array_equal(g, w, err_msg=d)
    w = np.asarray(want.values)
    assert got.values.dtype == w.dtype
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(w))
    np.testing.assert_allclose(got.values, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("time_chunk", [None, 20, 72, 100])
@pytest.mark.parametrize("conv", sorted(CONVERTERS))
def test_matrix_resident_and_streamed(small, conv, time_chunk):
    """T=72 is no multiple of 20: the streamer slides its last window."""
    got, want = both(small, conv, matrix=small[2], aggregate_time=None, time_chunk=time_chunk)
    assert got.values.shape == (6, 72)
    assert_da_close(got, want)
    np.testing.assert_array_equal(got.values[4], 0.0)


@pytest.mark.parametrize("conv", sorted(CONVERTERS))
def test_streamed_equals_resident_and_logs_chunks(small, conv):
    """Each chunk's pack (on the worker thread), convert and aggregate
    steps are profiler ranges named by their window; the call's own host
    work (the technology lookup and the matrix composition before the
    chunks, the per-unit scaling after them) is in ranges of the whole
    call, 0:72."""
    _, tc, m = small
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        streamed = CONVERTERS[conv](tc, matrix=m, aggregate_time=None, time_chunk=20)
    resident = CONVERTERS[conv](tc, matrix=m, aggregate_time=None)
    np.testing.assert_allclose(streamed.values, resident.values, rtol=1e-6, atol=1e-6)
    windows = ["0:20", "20:40", "40:60", "52:72"]
    expected = {"pack": ["0:72", "0:72"] + windows, "convert": windows,
                "aggregate": windows + ["0:72"]}
    for step, want in expected.items():
        ranges = sorted((e.time_range.start, e.name) for e in prof.events()
                        if e.name.startswith(step + " "))
        assert [name for _, name in ranges] == [f"{step} {w}" for w in want], step


@pytest.mark.parametrize("conv", sorted(CONVERTERS))
def test_packed_against_packed(small, conv):
    got, want = both(small, conv, matrix=small[2], aggregate_time=None, time_chunk=20,
                     stream_pack="int16")
    w = np.asarray(want.values)
    diff = np.abs(got.values - w)
    scale = np.abs(w).max()
    assert np.quantile(diff, 0.999) <= 1e-5 * scale
    assert diff.max() <= 2e-2 * scale
    resident, _ = both(small, conv, matrix=small[2], aggregate_time=None)
    assert np.abs(got.values - resident.values).max() <= 2e-2 * scale


@pytest.mark.parametrize("aggregate_time", ["sum", "mean", "legacy", None])
@pytest.mark.parametrize("conv", sorted(CONVERTERS))
def test_aggregate_time(small, conv, aggregate_time):
    got, want = both(small, conv, matrix=small[2], aggregate_time=aggregate_time)
    assert_da_close(got, want, rtol=1e-5, atol=2e-3 if aggregate_time == "sum" else 2e-5)


def test_legacy_warns(small):
    with pytest.warns(FutureWarning, match="legacy"):
        wind(small[1], matrix=small[2])


@pytest.mark.parametrize("aggregate_time", ["sum", None])
@pytest.mark.parametrize("conv", sorted(CONVERTERS))
def test_without_matrix(small, conv, aggregate_time):
    got, want = both(small, conv, aggregate_time=aggregate_time, time_chunk=30)
    assert_da_close(got, want, rtol=1e-5, atol=2e-3 if aggregate_time == "sum" else 2e-5)
    assert got.dims == (("y", "x") if aggregate_time else ("time", "y", "x"))


@pytest.mark.parametrize("time_chunk", [None, 25])
@pytest.mark.parametrize("conv", sorted(CONVERTERS))
def test_per_unit_and_capacity(small, conv, time_chunk):
    (got, gcap), (want, wcap) = both(small, conv, matrix=small[2], aggregate_time=None,
                                     per_unit=True, return_capacity=True,
                                     time_chunk=time_chunk)
    assert_da_close(got, want)
    assert got.attrs["units"] == "p.u."
    assert gcap.dims == wcap.dims and gcap.attrs == wcap.attrs
    np.testing.assert_allclose(gcap.values, np.asarray(wcap.values), rtol=1e-7)
    np.testing.assert_array_equal(got.values[4], 0.0)  # zero capacity -> 0


@pytest.mark.parametrize("conv", sorted(CONVERTERS))
def test_layout(small, conv):
    _, tc, m = small
    layout = np.random.default_rng(2).random(tc.shape)
    got, want = both(small, conv, layout=layout, aggregate_time="mean")
    assert_da_close(got, want)
    both_m = both(small, conv, matrix=m, layout=layout, aggregate_time=None,
                  index=np.arange(6) + 100)
    assert_da_close(*both_m)
    # a layout with labels is aligned by them: the x order reversed
    g = tc.grid_desc
    da = DataArray(layout[:, ::-1], coords={"y": g.y, "x": g.x[::-1]}, dims=("y", "x"))
    jda = JDataArray(layout[:, ::-1], coords={"y": g.y, "x": g.x[::-1]}, dims=("y", "x"))
    with jax.enable_x64(False):
        want = CONVERTERS[conv](small[0], layout=jda, aggregate_time="mean")
    assert_da_close(CONVERTERS[conv](tc, layout=da, aggregate_time="mean"), want)


@pytest.mark.parametrize("time_chunk", [None, 20])
@pytest.mark.parametrize("conv", sorted(CONVERTERS))
def test_banded_route(wide, monkeypatch, conv, time_chunk):
    monkeypatch.setattr(aggregate, "_DENSE_LIMIT", 1000)
    monkeypatch.setattr(jagg, "_DENSE_LIMIT", 1000)
    m = wide[2]
    calls = []
    banded = tbsr.banded_spmm
    monkeypatch.setattr(tbsr, "banded_spmm", lambda *a: calls.append(1) or banded(*a))
    got, want = both(wide, conv, matrix=m, aggregate_time=None, time_chunk=time_chunk)
    assert calls
    assert got.values.shape == (512, 48)
    assert_da_close(got, want)


def test_argument_errors(small):
    jc, tc, m = small
    with pytest.raises(ValueError, match="aggregate_time"):
        wind(tc, matrix=m, aggregate_time="max")
    with pytest.raises(ValueError, match="stream_pack requires"):
        wind(tc, matrix=m, aggregate_time=None, stream_pack="int16")
    with pytest.raises(ValueError, match="per_unit"):
        wind(tc, per_unit=True, aggregate_time=None)
    with pytest.raises(ValueError, match="not aligned"):
        wind(tc, matrix=m[:, :-1], aggregate_time=None)
    with pytest.raises(ValueError, match="single dimension"):
        wind(tc, matrix=m, index=[(1, 2)] * 6, aggregate_time=None)
    with pytest.raises(TypeError, match="as geometry"):
        wind(tc, shapes=["a"], aggregate_time=None)
    with pytest.raises(ValueError, match="ambiguous"):
        wind(tc, matrix=m, shapes=["a"], aggregate_time=None)
