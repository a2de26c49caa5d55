"""The port's rasters against the JAX package's, on the CPU: ``Raster``
(.npz and GeoTIFF, either package reading the other's files), GeoTIFF
decoding (strips and tiles, classic and BigTIFF, both byte orders,
deflate, LZW, PackBits, predictors 2 and 3, from files made here by a
small TIFF writer), ``geometry_mask`` by the C++ engine and by numpy,
``projected_mask``, ``pad_extent``, ``reproject_nearest`` (slice, separable
and general paths) and ``reproject_average`` (one CRS and across CRSs),
``binary_dilation``, and ``points_in_polygon`` of the port's engine
against the JAX package's binding.

Inputs are made from numpy seeds.  Both packages run the same float64
host code here, so every comparison is exact (arrays equal), except
``reproject_average``, held within 1e-12 relative (a product of the same
matrices).
"""

import struct
import zlib

import numpy as np
import pytest

from atlite_tpu import native as jnative
from atlite_tpu.core.grid import Affine as JAffine
from atlite_tpu.gis import geometry as JG
from atlite_tpu.gis import geotiff as jgeotiff
from atlite_tpu.gis import raster as jraster
from atlite_tpu_torch import native as tnative
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.gis import geometry as TG
from atlite_tpu_torch.gis import geotiff as tgeotiff
from atlite_tpu_torch.gis import raster as traster

X0, Y0, X1, Y1 = -4.0, 56.0, 1.5, 61.0


def jaffine(t):
    return JAffine(*t)


def jraster_of(r):
    """The same raster as a JAX-package object."""
    return jraster.Raster(r.data, jaffine(r.transform), r.crs, r.nodata)


def to_jax(geom):
    return JG.parse_geometry(geom.__geo_interface__)


def assert_same_raster(got, want):
    assert type(got).__name__ == type(want).__name__ == "Raster"
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.dtype == want.data.dtype
    assert tuple(got.transform) == tuple(want.transform)
    assert got.crs == want.crs
    assert (got.nodata is None) == (want.nodata is None)
    if got.nodata is not None:
        assert got.nodata == want.nodata or (np.isnan(got.nodata) and np.isnan(want.nodata))


# ---------------------------------------------------------------- Raster I/O
@pytest.mark.parametrize("crs, nodata", [(4326, 255), (3035, None), ("cea", 7),
                                         ("+proj=utm +zone=33 +ellps=GRS80", 255)],
                         ids=["4326", "3035-none", "cea", "utm-key"])
def test_npz_interchange(tmp_path, crs, nodata):
    rng = np.random.default_rng(0)
    r = traster.Raster(rng.integers(0, 9, (13, 17)).astype(np.uint8),
                       Affine(100.0, 0, 4.3e6, 0, -100.0, 3.6e6), crs, nodata)
    r.save(tmp_path / "port.npz")
    jraster_of(r).save(tmp_path / "jax.npz")
    for path in ("port.npz", "jax.npz"):
        assert_same_raster(traster.Raster.open(tmp_path / path),
                           jraster.Raster.open(tmp_path / path))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.uint16, np.int32,
                                   np.float32, np.float64])
@pytest.mark.parametrize("compression", ["deflate", "lzw", "packbits", "none"])
def test_geotiff_write_identical_and_read(tmp_path, dtype, compression):
    """Both writers make the same bytes; each reader reads either file."""
    rng = np.random.default_rng(1)
    data = (rng.random((37, 53)) * 100).astype(dtype)
    r = traster.Raster(data, Affine(0.01, 0, -4.2, 0, -0.01, 62.2), crs=3035, nodata=255)
    tgeotiff.write_geotiff(r, tmp_path / "port.tif", compression=compression)
    jgeotiff.write_geotiff(jraster_of(r), tmp_path / "jax.tif", compression=compression)
    assert (tmp_path / "port.tif").read_bytes() == (tmp_path / "jax.tif").read_bytes()
    got = traster.Raster.open(tmp_path / "jax.tif")
    assert_same_raster(got, jgeotiff.read_geotiff(tmp_path / "port.tif"))
    np.testing.assert_array_equal(got.data, data)


def test_geotiff_ascending_and_untagged(tmp_path):
    """An ascending-y raster is flipped north-up; no nodata stays None; a
    rotated transform is refused, as in the JAX package."""
    r = traster.Raster(np.arange(20, dtype=np.uint8).reshape(4, 5),
                       Affine(0.5, 0, 1.0, 0, 0.5, 2.0), 4326, nodata=None)
    tgeotiff.write_geotiff(r, tmp_path / "a.tif")
    assert_same_raster(tgeotiff.read_geotiff(tmp_path / "a.tif"),
                       jgeotiff.read_geotiff(tmp_path / "a.tif"))
    rot = traster.Raster(np.zeros((4, 4)), Affine(0.1, 0.01, 0, 0, -0.1, 1.0), 4326, None)
    with pytest.raises(ValueError, match="axis-aligned"):
        tgeotiff.write_geotiff(rot, tmp_path / "rot.tif")
    with pytest.raises(ValueError, match="EPSG"):
        tgeotiff.write_geotiff(traster.Raster(np.ones((2, 2)), Affine(1, 0, 0, 0, -1, 0), "cea",
                                              None), tmp_path / "cea.tif")


def _predict(block, predictor, endian):
    """TIFF predictor encoding of a (rows, cols) block: 2 horizontal
    differencing of the samples, 3 the floating-point byte-stream one."""
    if predictor == 2:
        d = block.copy()
        d[:, 1:] = block[:, 1:] - block[:, :-1]
        return d.astype(block.dtype.newbyteorder(endian)).tobytes()
    if predictor == 3:
        bpp = block.dtype.itemsize
        rows, cols = block.shape
        msb = np.frombuffer(block.astype(block.dtype.newbyteorder(">")).tobytes(),
                            np.uint8).reshape(rows, cols, bpp)
        streams = np.moveaxis(msb, 2, 1).reshape(rows, -1).astype(np.int16)
        diff = np.diff(streams, axis=1, prepend=0) % 256
        return diff.astype(np.uint8).tobytes()
    return block.astype(block.dtype.newbyteorder(endian)).tobytes()


def _compress(raw, code):
    if code == 8:
        return zlib.compress(raw)
    if code == 5:
        return tgeotiff._lzw_encode(raw)
    if code == 32773:
        return tgeotiff._packbits_encode(raw)
    return raw


def tiff_bytes(data, *, endian="<", big=False, tile=None, rows_per_strip=None,
               compression=1, predictor=1, epsg=3035, nodata=None):
    """A single-band GeoTIFF of ``data``: strips or (th, tw) tiles,
    classic or BigTIFF, either byte order, top-left at (4.3e6, 3.6e6),
    100 m pixels."""
    h, w = data.shape
    fmt = {"u": 1, "i": 2, "f": 3}[data.dtype.kind]
    if tile is None:
        rps = rows_per_strip or h
        blocks = [data[r:r + rps] for r in range(0, h, rps)]
    else:
        th, tw = tile
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw), data.dtype)
        pad[:h, :w] = data
        blocks = [pad[r:r + th, c:c + tw] for r in range(0, pad.shape[0], th)
                  for c in range(0, pad.shape[1], tw)]
    payloads = [_compress(_predict(b, predictor, endian), compression) for b in blocks]
    geokeys = [1, 1, 0, 2, 1024, 0, 1, 1, 3072, 0, 1, epsg]
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [data.dtype.itemsize * 8]),
               (259, 3, [compression]), (262, 3, [1]), (277, 3, [1]), (317, 3, [predictor]),
               (339, 3, [fmt]), (33550, 12, [100.0, 100.0, 0.0]),
               (33922, 12, [0.0, 0.0, 0.0, 4.3e6, 3.6e6, 0.0]), (34735, 3, geokeys)]
    off_type = 16 if big else 4
    if tile is None:
        entries += [(278, 4, [rps]), (273, off_type, None), (279, 4, [len(p) for p in payloads])]
    else:
        entries += [(322, 3, [tile[1]]), (323, 3, [tile[0]]), (324, off_type, None),
                    (325, 4, [len(p) for p in payloads])]
    if nodata is not None:
        entries.append((42113, 2, list(f"{nodata}".encode() + b"\0")))
    entries.sort(key=lambda e: e[0])
    codes = {2: "B", 3: "H", 4: "I", 12: "d", 16: "Q"}
    esz, inline, cnt_fmt, n_fmt = (20, 8, "Q", "Q") if big else (12, 4, "I", "H")
    head = 16 if big else 8
    ifd_len = struct.calcsize(endian + n_fmt) + esz * len(entries) + (8 if big else 4)
    data_start = head + ifd_len + sum(8 * len(v or payloads) + 8 for _, _, v in entries)
    offsets = np.cumsum([data_start] + [len(p) for p in payloads])[:-1].tolist()
    extra, ifd = b"", struct.pack(endian + n_fmt, len(entries))
    for tag, typ, vals in entries:
        vals = offsets if vals is None else vals
        enc = struct.pack(endian + codes[typ] * len(vals), *vals)
        ifd += struct.pack(endian + "HH" + cnt_fmt, tag, typ, len(vals))
        if len(enc) <= inline:
            ifd += enc.ljust(inline, b"\0")
        else:
            ifd += struct.pack(endian + cnt_fmt, head + ifd_len + len(extra))
            extra += enc.ljust(-(-len(enc) // 8) * 8, b"\0")
    ifd += b"\0" * (8 if big else 4)
    header = (endian == "<" and b"II" or b"MM") + (
        struct.pack(endian + "HHHQ", 43, 8, 0, head) if big else struct.pack(endian + "HI", 42, head))
    body = header + ifd + extra
    body += b"\0" * (data_start - len(body))
    return body + b"".join(payloads)


TIFF_CASES = {
    "strips-deflate": dict(rows_per_strip=7, compression=8),
    "strips-lzw-pred2": dict(rows_per_strip=5, compression=5, predictor=2),
    "strips-packbits-bigendian": dict(compression=32773, endian=">"),
    "tiles-deflate": dict(tile=(16, 16), compression=8),
    "tiles-lzw-pred2-bigendian": dict(tile=(16, 32), compression=5, predictor=2, endian=">"),
    "bigtiff-strips": dict(big=True, rows_per_strip=9),
    "bigtiff-tiles-deflate": dict(big=True, tile=(32, 16), compression=8),
    "bigtiff-bigendian-pred2": dict(big=True, endian=">", compression=8, predictor=2),
}


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.uint32, np.float32])
@pytest.mark.parametrize("case", sorted(TIFF_CASES))
def test_geotiff_decoders(case, dtype):
    rng = np.random.default_rng(2)
    data = np.floor(rng.random((41, 45)) * 250).astype(dtype)
    blob = tiff_bytes(data, nodata=255, **TIFF_CASES[case])
    got = tgeotiff.read_geotiff(blob)
    assert_same_raster(got, jgeotiff.read_geotiff(blob))
    np.testing.assert_array_equal(got.data, data)
    assert tuple(got.transform) == (100.0, 0.0, 4.3e6, 0.0, -100.0, 3.6e6) and got.crs == 3035


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("layout", [dict(rows_per_strip=4), dict(tile=(16, 16))],
                         ids=["strips", "tiles"])
def test_geotiff_float_predictor(dtype, layout):
    rng = np.random.default_rng(3)
    data = (rng.random((21, 35)) * 1000 - 200).astype(dtype)
    blob = tiff_bytes(data, compression=8, predictor=3, **layout)
    got = tgeotiff.read_geotiff(blob)
    assert_same_raster(got, jgeotiff.read_geotiff(blob))
    np.testing.assert_array_equal(got.data, data)


def test_geotiff_malformed_input_raises():
    blob = tiff_bytes(np.ones((8, 8), np.uint8), compression=8)
    for bad in (b"XX" + blob[2:], blob[:40], blob[:-20] + b"\xff" * 20):
        with pytest.raises(ValueError):
            jgeotiff.read_geotiff(bad)
        with pytest.raises(ValueError):
            tgeotiff.read_geotiff(bad)


# ------------------------------------------------------------- rasterization
def shapes_for_masks():
    return {
        "box": TG.box(X0 + 0.37, Y0 + 0.21, X1 - 1.13, Y1 - 0.77),
        "triangle": TG.Polygon([(X0 + 0.2, Y0 + 0.3), (X1 - 0.4, Y0 + 1.1), (-1.0, Y1 - 0.2)]),
        "holed": TG.Polygon([(X0, Y0), (X1, Y0), (X1, Y1), (X0, Y1)],
                            [[(-2.5, 57.5), (-0.5, 57.5), (-0.5, 59.5), (-2.5, 59.5)]]),
        "multi": TG.MultiPolygon([TG.box(X0 + 0.1, Y0 + 0.1, X0 + 1.3, Y0 + 1.4),
                                  TG.Polygon([(0.0, 59.0), (1.2, 59.4), (0.4, 60.8)])]),
        "geojson": {"type": "Polygon", "coordinates": [[(-3.0, 57.0), (0.0, 57.2), (0.3, 60.0),
                                                        (-2.6, 60.4), (-3.0, 57.0)]]},
    }


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("name", sorted(shapes_for_masks()))
def test_geometry_mask(monkeypatch, engine, name):
    geom = shapes_for_masks()[name]
    jgeom = geom if isinstance(geom, dict) else to_jax(geom)
    transform, shape = traster.padded_transform_and_shape((X0, Y0, X1, Y1), 0.02)
    if engine == "numpy":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    else:
        assert tnative.get_lib() is not None
    for invert in (False, True):
        got = traster.geometry_mask(geom, shape, transform, invert=invert)
        want = jraster.geometry_mask(jgeom, shape, jaffine(transform), invert=invert)
        np.testing.assert_array_equal(got, want)
        assert got.any() and not got.all()


@pytest.mark.parametrize("name", sorted(set(shapes_for_masks()) - {"geojson"}))
def test_points_in_polygon_engine_vs_jax_binding(name):
    geom = shapes_for_masks()[name]
    rng = np.random.default_rng(4)
    px, py = rng.uniform(X0 - 0.5, X1 + 0.5, 20_000), rng.uniform(Y0 - 0.5, Y1 + 0.5, 20_000)
    polys = geom.polygons if isinstance(geom, TG.MultiPolygon) else [geom]
    jpolys = [to_jax(p) for p in polys]
    assert jnative.get_lib() is not None
    for p, jp in zip(polys, jpolys):
        got = tnative.points_in_polygon(p, px, py)
        np.testing.assert_array_equal(got, jnative.points_in_polygon(jp, px, py))
        # numpy versions of both packages
        np.testing.assert_array_equal(got.astype(bool), TG.points_in_polygon(p, px, py))
        np.testing.assert_array_equal(TG.points_in_polygon(p, px, py),
                                      JG.points_in_polygon(jp, px, py))
    # XOR into a given buffer, as the JAX binding does
    out = np.ones(px.shape, np.uint8)
    tnative.points_in_polygon(polys[0], px, py, out=out)
    np.testing.assert_array_equal(out, 1 ^ jnative.points_in_polygon(jpolys[0], px, py))


@pytest.fixture(scope="module")
def codes_raster():
    transform, shape = traster.padded_transform_and_shape((X0, Y0, X1, Y1), 0.01)
    rng = np.random.default_rng(5)
    return traster.Raster((rng.random(shape) * 100).astype(np.int32), transform, 4326, 255)


def test_projected_mask(codes_raster):
    jr = jraster_of(codes_raster)
    geom = TG.box(X0 + 1, Y0 + 1, X0 + 2, Y0 + 2)
    for kw in (dict(), dict(transform=Affine(0.05, 0, X0 + 1, 0, -0.05, Y0 + 2),
                            shape=(20, 20), crs=4326)):
        got, gt = traster.projected_mask(codes_raster, geom, **kw)
        jkw = dict(kw, transform=jaffine(kw["transform"])) if kw else kw
        want, wt = jraster.projected_mask(jr, to_jax(geom), **jkw)
        np.testing.assert_array_equal(got, want)
        assert tuple(gt) == tuple(wt)
    far = TG.box(X0 - 10, Y0 - 10, X0 - 9, Y0 - 9)
    with pytest.raises(ValueError):
        traster.projected_mask(codes_raster, far)
    got, _ = traster.projected_mask(codes_raster, far, allow_no_overlap=True)
    np.testing.assert_array_equal(got, jraster.projected_mask(jr, to_jax(far),
                                                              allow_no_overlap=True)[0])
    # nodata None defaults to 255, and a geometry given in another CRS
    r = traster.Raster(np.ones((10, 12), np.uint8), Affine(0.1, 0, 0, 0, -0.1, 1.0), 4326, None)
    masked, _ = traster.projected_mask(r, [TG.box(0.2, 0.2, 0.8, 0.8)], crs=4326)
    assert masked.dtype != object and set(np.unique(masked)) <= {1, 255}
    g3035 = TG.transform_geometry(geom, 4326, 3035)
    got, _ = traster.projected_mask(codes_raster, g3035, geom_crs=3035)
    want, _ = jraster.projected_mask(jr, to_jax(g3035), geom_crs=3035)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["constant", "edge"])
def test_pad_extent(mode):
    rng = np.random.default_rng(6)
    src = rng.random((2, 30, 40))
    st = Affine(0.01, 0, -2.0, 0, -0.01, 58.0)
    for dst, crs in ((Affine(0.25, 0, -4, 0, -0.25, 62), 4326),
                     (Affine(4000.0, 0, 3e6, 0, -4000.0, 4e6), 3035)):
        got, gt = traster.pad_extent(src, st, dst, 4326, crs, mode=mode)
        want, wt = jraster.pad_extent(src, jaffine(st), jaffine(dst), 4326, crs, mode=mode)
        np.testing.assert_array_equal(got, want)
        assert tuple(gt) == tuple(wt)


def nearest_cases(r):
    st = r.transform
    return {
        "aligned": (Affine(st.a, 0, st.c - 7 * st.a, 0, st.e, st.f - 3 * st.e), 4326, (200, 150)),
        "separable": (Affine(0.013, 0, X0 - 0.1, 0, -0.017, Y1 + 0.2), 4326, (330, 450)),
        "cross-crs": (Affine(2000.0, 0, 3.40e6, 0, -2000.0, 4.32e6), 3035, (330, 250)),
    }


@pytest.mark.parametrize("case", ["aligned", "separable", "cross-crs"])
def test_reproject_nearest(codes_raster, case):
    dst, crs, shape = nearest_cases(codes_raster)[case]
    got = traster.reproject_nearest(codes_raster, dst, crs, shape)
    want = jraster.reproject_nearest(jraster_of(codes_raster), jaffine(dst), crs, shape)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert (got == 255).any() and (got != 255).any()


def test_reproject_nearest_separable_matches_bruteforce():
    """The separable fast path index-matches the per-pixel definition:
    destination centre -> floor of the source's inverse affine."""
    rng = np.random.default_rng(0)
    src = traster.Raster(rng.integers(0, 7, (33, 29)).astype(np.int16),
                         Affine(130.0, 0, 1037.0, 0, -130.0, 9020.0), 3035, 255)
    dst_t = Affine(100.0, 0, 900.0, 0, -100.0, 9100.0)
    out = traster.reproject_nearest(src, dst_t, 3035, (51, 47), nodata=255)
    inv = src.transform.inverse
    cc = np.floor(inv.a * (dst_t.a * (np.arange(47) + 0.5) + dst_t.c) + inv.c).astype(int)
    rr = np.floor(inv.e * (dst_t.e * (np.arange(51) + 0.5) + dst_t.f) + inv.f).astype(int)
    oracle = np.full((51, 47), 255, np.int16)
    for r, ri in enumerate(rr):
        for c, ci in enumerate(cc):
            if 0 <= ci < 29 and 0 <= ri < 33:
                oracle[r, c] = src.data[ri, ci]
    np.testing.assert_array_equal(out, oracle)


@pytest.mark.parametrize("case", ["same-crs", "same-crs-nodata", "cross-crs"])
def test_reproject_average(codes_raster, case):
    data = codes_raster.data.astype(float)
    data[5:9, 3:40] = np.nan
    nodata = 17 if case == "same-crs-nodata" else None
    r = traster.Raster(data, codes_raster.transform, 4326, nodata)
    if case == "cross-crs":
        dst, crs, shape = Affine(20000.0, 0, 3.40e6, 0, -20000.0, 4.32e6), 3035, (33, 25)
    else:
        dst, crs, shape = Affine(0.25, 0, X0 - 0.1, 0, -0.3, Y1 + 0.2), 4326, (19, 24)
    got = traster.reproject_average(r, dst, crs, shape)
    want = jraster.reproject_average(jraster_of(r), jaffine(dst), crs, shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.isfinite(got).any()


def test_binary_dilation():
    rng = np.random.default_rng(7)
    m = rng.random((60, 70)) < 0.02
    for it in (1, 3):
        np.testing.assert_array_equal(traster.binary_dilation(m, it),
                                      jraster.binary_dilation(m, it))
