"""The port's GRIB codec (``atlite_tpu_torch/io/grib.py`` with
``png``/``jp2``/``aec``) against the JAX package's.

Decoders: the same bytes give the same records, bit for bit — values
(dtype, NaN mask), coordinates, times, parameters and expver — on the
ERA5 sample file and on every fixture kind of ``tests/test_grib.py``:
GRIB1 and GRIB2 simple packing at several widths, bitmaps, regular and
reduced Gaussian grids, IEEE, PNG, JPEG 2000 and CCSDS templates, the
complex and spatial-differencing payloads (5.2/5.3) and the
interval-end template 4.8.  Encoders: the same records give the same
bytes.  The port's bit (un)packing is another formulation (a 40-bit
window gathered a value at a time, a big-endian view at whole-byte
widths), held equal to JAX's on every width 0..32 and bit offset.  The
trust-boundary refusals raise the same classes.  No tolerance anywhere.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from atlite_tpu.io import aec as jaec
from atlite_tpu.io import grib as jgrib
from atlite_tpu.io import jp2 as jjp2
from atlite_tpu.io import png as jpng
from atlite_tpu_torch.io import aec, grib, jp2, png

TESTS = Path(__file__).parent
SAMPLE = TESTS / "data" / "era5_sample.grib"


def jax_tests(name):
    """A module of the JAX package's tests, for its fixture functions."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JG = jax_tests("test_grib")


def same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                assert np.array_equal(g[k], w[k], equal_nan=True), k
            else:
                assert type(g[k]) is type(w[k]) and g[k] == w[k], k


def same_dataset(got, want):
    (gd, gc), (wd, wc) = got, want
    assert list(gd) == list(wd) and list(gc) == list(wc)
    for k in wd:
        assert gd[k][0] == wd[k][0] and gd[k][1].dtype == wd[k][1].dtype
        assert np.array_equal(gd[k][1], wd[k][1], equal_nan=True)
    for k in wc:
        assert gc[k].dtype == wc[k].dtype and np.array_equal(gc[k], wc[k])


@pytest.mark.parametrize("nbits", range(33))
def test_bit_packing(nbits):
    rng = np.random.default_rng(nbits)
    for off in (0, 3, 8, 13):
        n = int(rng.integers(0, 300))
        v = rng.integers(0, 2**nbits, n, dtype=np.int64) if nbits else np.zeros(n, np.int64)
        assert grib._pack_bits(v, nbits) == jgrib._pack_bits(v, nbits)
        buf = bytes(rng.integers(0, 256, (off + nbits * n + 7) // 8 + 3, dtype=np.uint8))
        got, want = grib._unpack_bits(buf, nbits, n, off), jgrib._unpack_bits(buf, nbits, n, off)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("args, match", [
    ((b"\x00" * 64, 64, 4), "packing width"), ((b"\x00" * 4, 16, 4), "too short"),
    ((b"\x00" * 4, 8, -1), "point count"), ((b"\x00" * 4, 16, 2, 3), "too short")])
def test_unpack_bits_refusals(args, match):
    for unpack in (jgrib._unpack_bits, grib._unpack_bits):
        with pytest.raises(ValueError, match=match):
            unpack(*args)


def test_era5_sample_file():
    buf = SAMPLE.read_bytes()
    want = jgrib.read(buf)
    got = grib.read(buf)
    assert len(got) == 313
    same_records(got, want)
    same_records(grib.read(SAMPLE), want)
    same_dataset(grib.to_dataset(got), jgrib.to_dataset(want))


def simple_records(nbits, nan=False, expver=None, interval=None, descending=True):
    recs = JG._recs(nt=2, nbits=nbits)
    for r in recs:
        if not descending:
            r["lats"] = r["lats"][::-1]
        if nan:
            r["values"] = r["values"].copy()
            r["values"][1, 2] = np.nan
            r["values"][-1, :] = np.nan
        if expver is not None:
            r["expver"] = expver
        if interval is not None:
            r["interval_hours"] = interval
    return recs


SIMPLE = {
    "16bit": dict(nbits=16), "8bit": dict(nbits=8), "12bit": dict(nbits=12),
    "24bit": dict(nbits=24), "32bit": dict(nbits=32), "bitmap": dict(nbits=16, nan=True),
    "expver": dict(nbits=16, expver="0005"), "expver_short": dict(nbits=16, expver="1"),
    "ascending": dict(nbits=16, descending=False), "interval": dict(nbits=16, interval=1),
}


@pytest.mark.parametrize("edition", [1, 2])
@pytest.mark.parametrize("case", list(SIMPLE))
def test_simple_packing(edition, case):
    recs = simple_records(**SIMPLE[case])
    enc_j, enc_t = (jgrib.encode_grib1, grib.encode_grib1) if edition == 1 else \
        (jgrib.encode_grib2, grib.encode_grib2)
    raw = enc_j(recs)
    assert enc_t(recs) == raw
    got, want = grib.read(raw), jgrib.read(raw)
    same_records(got, want)
    same_dataset(grib.to_dataset(got), jgrib.to_dataset(want))


def test_mixed_editions_and_dual_stream():
    recs = JG._recs(nt=1)
    blob = jgrib.encode_grib1(recs[:1]) + jgrib.encode_grib2(recs[1:2])
    same_records(grib.read(blob), jgrib.read(blob))
    # ERA5 and ERA5T over the same hour: final ERA5 wins in both packages
    two = [dict(recs[0], expver="0005"), dict(recs[0], expver="0001",
                                                values=recs[0]["values"] + 1)]
    raw = jgrib.encode_grib1(two)
    same_dataset(grib.to_dataset(grib.read(raw)), jgrib.to_dataset(jgrib.read(raw)))


@pytest.mark.parametrize("edition", [1, 2])
@pytest.mark.parametrize("case", ["reduced", "reduced_dense", "reduced_bitmap", "regular"])
def test_gaussian_grids(edition, case):
    N = 8
    if case == "regular":
        glats = jgrib.gaussian_latitudes(N)
        lons = np.arange(0, 360, 22.5)
        rec = {"shortName": "t2m", "values": JG._analytic(glats[:, None], lons[None, :]),
               "lats": glats, "lons": lons, "gauss_n": N,
               "valid_time": np.datetime64("2013-01-01T00:00"), "nbits": 16}
    else:
        glats, pl, flat = JG._reduced_fixture(N=N, dense=case == "reduced_dense")
        if case == "reduced_bitmap":
            flat = flat.copy()
            flat[5] = np.nan
        rec = {"shortName": "t2m", "values": flat, "lats": glats,
               "lons": np.array([0.0, 352.5]), "pl": pl, "gauss_n": N,
               "valid_time": np.datetime64("2013-01-01T00:00"), "nbits": 16}
    enc_j, enc_t = (jgrib.encode_grib1, grib.encode_grib1) if edition == 1 else \
        (jgrib.encode_grib2, grib.encode_grib2)
    raw = enc_j([rec])
    assert enc_t([rec]) == raw
    same_records(grib.read(raw), jgrib.read(raw))
    assert np.array_equal(grib.gaussian_latitudes(N), jgrib.gaussian_latitudes(N))


def packed_record(packing, nbits=16, shape=(12, 17), nan=True, seed=4):
    rng = np.random.default_rng(seed)
    vals = rng.random(shape) * 40 + 250
    if nan:
        vals[3, 5] = np.nan
    return {"shortName": "t2m", "values": vals,
            "lats": np.linspace(60, 49, shape[0]), "lons": np.linspace(-4, 12, shape[1]),
            "valid_time": np.datetime64("2013-01-01T00:00"),
            "param": (0, 0, 0, 103, 2), packing: True, "nbits": nbits}


@pytest.mark.parametrize("packing, nbits, shape", [
    ("ieee", 16, (6, 9)), ("png", 8, (12, 17)), ("png", 16, (12, 17)), ("png", 24, (12, 17)),
    ("png", 32, (12, 17)), ("png", 16, (120, 150)), ("ccsds", 16, (12, 17)),
    ("ccsds", 24, (12, 17)), ("jp2", 16, (14, 19)), ("jp2", 16, (120, 150))])
def test_grib2_packings(packing, nbits, shape):
    if packing == "ccsds" and not aec.available():
        assert not jaec.available()
        pytest.skip("libaec not present (both packages raise without it)")
    if packing == "jp2":
        pytest.importorskip("PIL.Image")  # the fixture encoder
        if not jp2.available():
            assert not jjp2.available()
            pytest.skip("libopenjp2 not present (both packages raise without it)")
    rec = packed_record(packing, nbits, shape, nan=nbits != 24 or packing != "ccsds")
    raw = jgrib.encode_grib2([rec])
    assert grib.encode_grib2([rec]) == raw
    same_records(grib.read(raw), jgrib.read(raw))


@pytest.mark.parametrize("dtype, channels", [("u1", 1), ("u2", 1), ("u1", 3), ("u1", 4),
                                            ("u2", 2)])
def test_png_codec(dtype, channels):
    img = np.random.default_rng(0).integers(0, np.iinfo(dtype).max, (7, 11, channels)).astype(dtype)
    blob = jpng.encode(img)
    assert png.encode(img) == blob
    got, want = png.decode(blob), jpng.decode(blob)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def complex_payloads():
    rng = np.random.default_rng(101)
    out = [(bytes([0x3A, 0x44, 0x00, 0x00, 0x1B, 0xA0]),
            dict(ndata=7, drs_template=2, nbits=4, ngroups=2, group_width_ref=0,
                 group_width_bits=3, group_len_ref=4, group_len_inc=1, group_len_last=3,
                 group_len_bits=8)),
           (bytes([0x80, 0x03, 0x00, 0x02, 0x00, 0x40, 0x00, 0x0D]),
            dict(ndata=4, drs_template=3, nbits=4, ngroups=1, group_width_ref=0,
                 group_width_bits=3, group_len_ref=4, group_len_inc=1, group_len_last=4,
                 group_len_bits=8, spatial_order=1, spatial_desc_bytes=2))]
    for order in (0, 1, 2):
        for case in range(4):
            n = int(rng.integers(order + 1, 200))
            sizes, left = [], n
            while left:
                s = int(min(left, rng.integers(1, 40)))
                sizes.append(s)
                left -= s
            desc = [1, 2, 4][case % 3]
            vmax = 25 if (order and desc == 1) else 500
            vals = rng.integers(-vmax, vmax, n) if order else rng.integers(0, 900, n)
            out.append(JG._encode_complex(vals, sizes, order=order, desc_bytes=desc))
    return out


@pytest.mark.parametrize("i", range(len(complex_payloads())))
def test_complex_packing(i):
    data, meta = complex_payloads()[i]
    got, want = grib._decode_complex(data, dict(meta)), jgrib._decode_complex(data, dict(meta))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    full = dict(meta, ref=250.0, bin_scale=-2, dec_scale=1)
    got = grib._decode_grib2_data(data, dict(full))
    want = jgrib._decode_grib2_data(data, dict(full))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_reduced_to_regular():
    pl = [96, 128, 64]
    flat = np.random.default_rng(0).random(sum(pl))
    for a, b in zip(grib._reduced_to_regular(flat, pl, 0.0, 144),
                    jgrib._reduced_to_regular(flat, pl, 0.0, 144)):
        assert np.array_equal(a, b)


def refusal_cases():
    rng = np.random.default_rng(8)
    rec = {"shortName": "t2m", "values": rng.random((4, 5)) * 10 + 270,
           "lats": np.linspace(52, 50, 4), "lons": np.linspace(0, 4, 5),
           "valid_time": np.datetime64("2013-01-01T03:00"), "param": (0, 0, 0, 103, 2),
           "nbits": 16}
    cases = {}
    raw = bytearray(jgrib.encode_grib1([rec]))
    raw[8 + 17] = 77
    cases["grib1_time_unit"] = bytes(raw)
    raw = bytearray(jgrib.encode_grib1([rec]))
    raw[8 + 28 + 32 + 3] |= 0x10
    cases["grib1_bds_flags"] = bytes(raw)
    raw = bytearray(jgrib.encode_grib2([rec]))
    raw[raw.find(bytes([0, 0, 0, 34, 4])) + 17] = 9
    cases["grib2_time_unit"] = bytes(raw)
    raw = bytearray(jgrib.encode_grib2([rec]))
    idx = raw.find(bytes([0, 0, 0, 34, 4]))
    raw[idx + 7:idx + 9] = (20).to_bytes(2, "big")
    cases["grib2_product_template"] = bytes(raw)
    raw = bytearray(jgrib.encode_grib2([rec]))
    raw[idx + 7:idx + 9] = (1).to_bytes(2, "big")
    cases["grib2_ensemble_prefix"] = bytes(raw)
    cases["no_messages"] = b"<html>a CDS error document, not gridded bytes</html>"
    cases["truncated"] = jgrib.encode_grib1([rec])[:40]
    return cases


@pytest.mark.parametrize("case", list(refusal_cases()))
def test_trust_boundary(case):
    blob = refusal_cases()[case]
    try:
        want = jgrib.read(blob)
    except Exception as exc:  # noqa: BLE001  (the class is compared)
        with pytest.raises(type(exc)):
            grib.read(blob)
        return
    same_records(grib.read(blob), want)


def test_to_dataset_refusals():
    rec = JG._recs(nt=1)[0]
    rec2 = dict(rec, lats=np.linspace(42, 40, 11), valid_time=np.datetime64("2013-06-01T04"))
    raw = jgrib.encode_grib1([rec]) + jgrib.encode_grib1([rec2])
    for g in (jgrib, grib):
        with pytest.raises(ValueError, match="different grids"):
            g.to_dataset(g.read(raw))
        with pytest.raises(ValueError, match="no GRIB records"):
            g.to_dataset([])
    for g in (jgrib, grib):
        with pytest.raises(NotImplementedError, match="missing-value"):
            g._decode_complex(b"\x00" * 64, {"missing_mgmt": 1, "ndata": 4, "drs_template": 2})
