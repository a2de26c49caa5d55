"""The streamer's int16 pack in native code (``native.pack16``) against the
numpy loop it replaces (``cutout._pack_numpy``), on the CPU.

Held bit for bit: the codes and each field's (lo, hi) of linear and
log-space fields, 1% NaN, values on half steps (round half to even), both
ends of the code range, an all-NaN chunk; float32, float64, memory-mapped
(a reopened ``.atc`` store) and strided sources; 1, 2 and the affinity's
threads; several fields of mixed kinds in one call.  Through ``Cutout``:
a chunk beyond its pack range raises the same message on both routes,
``ATLITE_TPU_NO_NATIVE=1`` takes the numpy loop (``Cutout.packed_native``
stays), the native route counts fields x chunks, and a streamed int16
``wind`` and ``pv`` give the same answers, bit for bit, on both routes.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from atlite_tpu_torch import Cutout, native
from atlite_tpu_torch.core.grid import Grid
from atlite_tpu_torch.cutout import _pack_numpy

torch.set_num_threads(1)

SHAPE = (24, 13, 17)  # hours, y, x
# exact binary parameters: (k + 0.5) * SCALE + OFF is a float32 value
OFF, SCALE = -12.5, 2.0 ** -8


def linear(rng):
    v = rng.uniform(-10.0, 30.0, SHAPE)
    return v, (float(v.min()), float(v.max() - v.min()) / 65534.0, False)


def log_space(rng):
    v = np.exp(rng.uniform(np.log(2e-4), np.log(1.2), SHAPE))
    lo, hi = np.log(v.min()), np.log(v.max())
    return v, (float(lo), float(hi - lo) / 65534.0, True)


def nan_share(rng):
    v, params = linear(rng)
    v[rng.random(SHAPE) < 0.01] = np.nan
    assert np.isnan(v).any()
    return v, params


def half_steps(rng):
    k = rng.integers(0, 65534, SHAPE)
    return (k + 0.5) * SCALE + OFF, (OFF, SCALE, False)


def ends(rng):
    # codes 0 and 65534, and within half a step beyond either end
    steps = rng.choice([0.0, -0.25, -0.5, 0.5, 65534.0, 65533.5, 65534.25, 65534.5], SHAPE)
    return steps * SCALE + OFF, (OFF, SCALE, False)


def all_nan(rng):
    return np.full(SHAPE, np.nan), (0.0, 1.0, False)  # pack_params of an all-NaN field


CASES = {"linear": linear, "log": log_space, "nan_1pct": nan_share, "half_steps": half_steps,
         "ends": ends, "all_nan": all_nan}


def stored(values, tmp_path):
    """``values`` in float32 through a written and reopened ``.atc`` store:
    the store's memory map."""
    T, Y, X = values.shape
    grid = Grid(x=np.arange(X) * 0.25, y=50.0 + np.arange(Y) * 0.25,
                time=np.datetime64("2013-01-01T00", "ns") + np.arange(T) * np.timedelta64(1, "h"),
                crs=4326)
    Cutout(data={"v": values.astype(np.float32)}, grid_desc=grid, device="cpu",
           attrs={"module": "era5", "dx": 0.25, "dy": 0.25}).to_file(tmp_path / "c.atc")
    a = Cutout(tmp_path / "c.atc", device="cpu").data["v"]
    assert isinstance(a, np.memmap)
    return a


def source(values, kind, tmp_path):
    if kind == "float64":
        return values
    if kind == "memmap":
        return stored(values, tmp_path)
    if kind == "strided":
        wide = np.zeros(values.shape[:2] + (2 * values.shape[2],), np.float32)
        wide[..., ::2] = values
        a = wide[..., ::2]
        assert not a.flags.c_contiguous
        return a
    return values.astype(np.float32)


def same_range(got, want):
    for g, w in zip(got, want):
        assert g == w or (np.isnan(g) and np.isnan(w))


@pytest.mark.parametrize("threads", [1, 2, "affinity"])
@pytest.mark.parametrize("kind", ["float32", "float64", "memmap", "strided"])
@pytest.mark.parametrize("case", list(CASES))
def test_codes_equal_the_numpy_loop(case, kind, threads, tmp_path):
    values, params = CASES[case](np.random.default_rng(25))
    a = source(values, kind, tmp_path)
    if threads == "affinity":
        threads = len(os.sched_getaffinity(0))
    want = np.empty((1,) + SHAPE, np.uint16)
    want_range = _pack_numpy(a, params, want[0])
    got = np.full((1,) + SHAPE, 7, np.uint16)
    (got_range,) = native.pack16([a], [params], got, threads=threads)
    np.testing.assert_array_equal(got, want)
    same_range(got_range, want_range)
    if case == "half_steps":  # half to even: every code even
        assert not (got % 2).any()
    if case == "all_nan":
        assert (got == 65535).all() and np.isnan(got_range).all()


@pytest.mark.parametrize("threads", [1, 3, None])
def test_mixed_fields_in_one_call(threads):
    """Each field of one call keeps its own source, kind and parameters."""
    rng = np.random.default_rng(7)
    cases = [CASES[c](rng) for c in ("linear", "log", "nan_1pct", "ends", "all_nan")]
    sources = [v.astype(np.float32) if i % 2 else v for i, (v, _) in enumerate(cases)]
    params = [p for _, p in cases]
    want = np.empty((len(cases),) + SHAPE, np.uint16)
    want_ranges = [_pack_numpy(a, p, w) for a, p, w in zip(sources, params, want)]
    got = np.empty_like(want)
    got_ranges = native.pack16(sources, params, got, threads=threads)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_ranges, want_ranges):
        same_range(g, w)


@pytest.mark.parametrize("n, threads", [(1, 1), (native.MIN_PACK_BLOCK - 1, 1),
                                        (2 * native.MIN_PACK_BLOCK, 2), (10 ** 9, None)])
def test_thread_count_follows_the_affinity(n, threads):
    cores = len(os.sched_getaffinity(0))
    assert native.pack_threads(n) == (cores if threads is None else min(cores, threads))


# ------------------------------------------------------------ through Cutout
KW = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 62),
          time=slice("2013-01-01", "2013-01-02"))  # 48 h: three chunks of 16


@pytest.fixture(scope="module")
def cut():
    return Cutout(device="cpu", **KW).prepare(features=["wind", "influx", "temperature"])


def route_to(monkeypatch, route):
    """Load the pack anew, with ``ATLITE_TPU_NO_NATIVE=1`` for numpy."""
    monkeypatch.setattr(native, "_pack_lib", None)
    monkeypatch.setattr(native, "_pack_tried", False)
    if route == "numpy":
        monkeypatch.setenv("ATLITE_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("ATLITE_TPU_NO_NATIVE", raising=False)
    assert (native.get_pack_lib() is None) == (route == "numpy")


@pytest.mark.parametrize("shift", [-1.0, 1.0])
def test_out_of_range_raises_the_same_message(cut, shift, monkeypatch):
    """A chunk whose values reach past the pack range by a step raises the
    numpy loop's message, with the same (lo, hi)."""
    c = Cutout(data=dict(cut.data), grid_desc=cut.grid_desc, attrs=dict(cut.attrs),
               var_attrs=dict(cut.var_attrs), device="cpu")
    names = ["temperature", "influx_direct"]
    params = c.pack_params(names)
    off, scale, _ = params["influx_direct"]
    a = c.data["influx_direct"]
    c.data["influx_direct"] = np.where(a == (a.max() if shift > 0 else a.min()),
                                       a + shift * 2 * scale, a)
    messages = []
    for route in ("native", "numpy"):
        route_to(monkeypatch, route)
        sub = c.isel_time(0, 48, only=set(names), pack16=params)
        with pytest.raises(ValueError, match="'influx_direct'.*outside its int16 pack range") \
                as info:
            sub._pack(sub.dtype)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("method", ["wind", "pv"])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_routes_count_and_answer_alike(cut, method, route, monkeypatch):
    """A streamed int16 call: the native route counts fields x chunks in
    ``Cutout.packed_native``, the numpy route nothing; the answers of both
    equal the native route's bit for bit."""
    ncells = cut.shape[0] * cut.shape[1]
    m = sp.random(3, ncells, density=0.3, random_state=1, format="csr")
    tech = {"wind": ("Vestas_V112_3MW",), "pv": ("CSi", {"slope": 35.0, "azimuth": 180.0})}
    call = getattr(cut, method)

    def streamed():
        return call(*tech[method], matrix=m, aggregate_time=None, time_chunk=16,
                    stream_pack="int16").values

    route_to(monkeypatch, "native")
    want = streamed()
    route_to(monkeypatch, route)
    packed, nbytes = Cutout.packed_native, Cutout.streamed_bytes
    got = streamed()
    counted = Cutout.packed_native - packed
    fields_x_chunks = (Cutout.streamed_bytes - nbytes) // (2 * 16 * ncells)
    assert counted == (fields_x_chunks if route == "native" else 0)
    if method == "wind":  # wnd100m, wnd10m and roughness, three chunks
        assert fields_x_chunks == 3 * 3
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 48) and np.isfinite(got).all()
