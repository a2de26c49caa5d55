"""Fuzz parity of the port's decoders with the JAX package's, on the
corpora and seeds of ``tests/test_codec_fuzz.py``: truncations, bit flips
and 4-byte field edits of GRIB1 and GRIB2 messages (with a bitmap), a
reduced Gaussian GRIB1 message, the alternative GRIB2 packings, a
NetCDF-3 file with a record dimension, and HDF5 files from the port's
writer and from libhdf5.  On each mutated input the port raises the same
exception class as JAX, or decodes to the same arrays bit for bit.

The corpora, seeds and counts are those of the JAX tests (each case
runs in well under a second).
"""

import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest

from atlite_tpu.io import aec as jaec
from atlite_tpu.io import grib as jgrib
from atlite_tpu.io import hdf5 as jhdf5
from atlite_tpu.io import jp2 as jjp2
from atlite_tpu.io import netcdf3 as jnetcdf3
from atlite_tpu_torch.io import grib, hdf5, netcdf3

TESTS = Path(__file__).parent
COUNTS = dict(n_truncate=30, n_flip=40, n_field=30)


def jax_tests(name):
    """A module of the JAX package's tests, for its corpora."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JF = jax_tests("test_codec_fuzz")


def mutations(data, rng, n_truncate, n_flip, n_field):
    """The corruptions of test_codec_fuzz._fuzz, in its order."""
    data = bytes(data)
    n = len(data)
    for _ in range(n_truncate):
        yield data[: int(rng.integers(1, n))]
    for _ in range(n_flip):
        i = int(rng.integers(0, n))
        bit = 1 << int(rng.integers(0, 8))
        b = bytearray(data)
        b[i] ^= bit
        yield bytes(b)
    for _ in range(n_field):
        i = int(rng.integers(0, max(n - 4, 1)))
        b = bytearray(data)
        b[i:i + 4] = int(rng.integers(0, 2**32)).to_bytes(4, "big")
        yield bytes(b)


def same(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want, equal_nan=want.dtype.kind in "fc")
    else:
        assert type(got) is type(want) and (got == want or (got != got and want != want))


def fuzz_parity(data, port_decode, jax_decode, seed, **counts):
    counts = {**COUNTS, **counts}
    decoded = raised = 0
    for blob in mutations(data, np.random.default_rng(seed), **counts):
        t0 = time.perf_counter()
        try:
            want = jax_decode(blob)
        except Exception as exc:  # noqa: BLE001  (the class is compared)
            with pytest.raises(type(exc)):
                port_decode(blob)
            raised += 1
        else:
            same(port_decode(blob), want)
            decoded += 1
        assert time.perf_counter() - t0 < JF.TIME_BUDGET
    assert decoded + raised == sum(counts.values())


@pytest.mark.parametrize("edition", [1, 2])
def test_grib(edition):
    data = JF._grib_fixture(edition)
    fuzz_parity(data, grib.read, jgrib.read, 100 + edition)


def test_grib_reduced_gaussian():
    N = 8
    pl = np.array([4 * min(i + 1, 2 * N - i) + 16 for i in range(2 * N)])
    rec = {"shortName": "t2m", "values": np.linspace(250, 300, int(pl.sum())),
           "lats": jgrib.gaussian_latitudes(N), "lons": np.array([0.0, 352.5]),
           "valid_time": np.datetime64("2013-01-01T00:00"), "pl": pl, "gauss_n": N, "nbits": 16}
    fuzz_parity(jgrib.encode_grib1([rec]), grib.read, jgrib.read, 7)


@pytest.mark.parametrize("packing", ["png", "ccsds", "ieee", "jp2"])
def test_grib2_alt_packings(packing):
    if packing == "ccsds" and not jaec.available():
        pytest.skip("libaec not present")
    if packing == "jp2":
        pytest.importorskip("PIL.Image")  # the fixture encoder
        if not jjp2.available():
            pytest.skip("libopenjp2 not present")
    rng = np.random.default_rng(12)
    rec = {"shortName": "t2m", "values": rng.random((8, 10)) * 30 + 270,
           "lats": np.linspace(60, 50, 8), "lons": np.linspace(-4, 3, 10),
           "valid_time": np.datetime64("2013-01-01T00:00"),
           "param": (0, 0, 0, 103, 2), "nbits": 16, packing: True}
    fuzz_parity(jgrib.encode_grib2([rec]), grib.read, jgrib.read, 200,
                n_truncate=20, n_flip=30, n_field=20)


def test_netcdf3(tmp_path):
    fuzz_parity(JF._netcdf3_fixture(tmp_path), netcdf3.read, jnetcdf3.read, 2)


def test_hdf5_port_written(tmp_path):
    fuzz_parity(JF._hdf5_fixture(tmp_path), hdf5.read_netcdf4, jhdf5.read_netcdf4, 4)


def test_hdf5_h5py_written(tmp_path):
    h5py = pytest.importorskip("h5py")
    fn = tmp_path / "g.nc"
    rng = np.random.default_rng(5)
    with h5py.File(fn, "w") as f:
        f.attrs["k"] = "v"
        f.create_dataset("a", data=rng.random((20, 7)), chunks=(6, 7), compression="gzip",
                         shuffle=True)
        f.create_dataset("b", data=np.arange(9, dtype="i4"))
    fuzz_parity(fn.read_bytes(), lambda b: hdf5.read(b)[:2], lambda b: jhdf5.read(b)[:2], 6)
