"""The port's device path of the availability matrix
(``gis.kernels.availability_matrix_device``), run on the CPU, against the
JAX package's device path (``atlite_tpu.gis.kernels``, JAX on the CPU with
x64 off, float32 as on its chip), on the cases of tests/test_gis_kernels.py
(its two shape-sharded ones, ``mesh=``, are in
tests/test_torch_sharded_cutout.py).

On every case the fine masks themselves are compared: the rasterized
shapes (``rasterize_shapes``) and the shapes AND NOT the exclusion mask
(JAX's ``_block_masks``) on the case's whole fine lattice must be equal pixel
for pixel.  Availability must be within 1e-5 absolute of JAX's in the
excluder's CRS (two float32 products with fractional overlap weights,
summed in another order) and within 1e-6 across CRSs (integer counts of
the same pixels, divided in float64).  Against the port's own host path,
the device path is held within 2e-2, as tests/test_gis_kernels.py holds
JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import atlite_tpu
from atlite_tpu.core.grid import Affine as JAffine
from atlite_tpu.gis import exclusion as jexcl
from atlite_tpu.gis import geometry as JG
from atlite_tpu.gis import kernels as JK
from atlite_tpu.gis import raster as jraster
import atlite_tpu_torch
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.gis import exclusion as texcl
from atlite_tpu_torch.gis import geometry as TG
from atlite_tpu_torch.gis import kernels as TK
from atlite_tpu_torch.gis import raster as traster
from atlite_tpu_torch.gis.crs import transform_points

torch.set_num_threads(1)

X0, Y0, X1, Y1 = -4.0, 56.0, 1.5, 61.0
SAME_CRS_ATOL = 1e-5
CROSS_CRS_ATOL = 1e-6
HOST_ATOL = 2e-2


@pytest.fixture(scope="module")
def pair():
    kw = dict(module="synthetic", bounds=(-4, 56, 1.5, 62), time="2013-01-01")
    return atlite_tpu.Cutout(path=None, **kw), atlite_tpu_torch.Cutout(device="cpu", **kw)


def jgeom(g):
    return JG.parse_geometry(g.__geo_interface__)


def excluders(crs, res, rasters=(), geometries=()):
    """A pair of equal excluders (port, JAX): rasters as (data, transform,
    crs, kwargs), geometries as (port geometries, kwargs)."""
    t = texcl.ExclusionContainer(crs, res=res)
    j = jexcl.ExclusionContainer(crs, res=res)
    for data, tr, rcrs, kw in rasters:
        nodata = kw.get("nodata", 255)  # the raster's own, as the layer's
        t.add_raster(traster.Raster(data, tr, rcrs, nodata), **kw)
        j.add_raster(jraster.Raster(data, JAffine(*tr), rcrs, nodata), **kw)
    for geoms, kw in geometries:
        t.add_geometry(list(geoms), **kw)
        j.add_geometry([jgeom(g) for g in geoms], **kw)
    return t, j


def jax_device(jc, shapes, exc, **kw):
    with jax.enable_x64(False):
        return np.asarray(JK.availability_matrix_device(jc, [jgeom(g) for g in shapes], exc, **kw))


def lattice(cutout, excluder):
    """The fine lattice of the device path: (transform, ny, nx, px, py)."""
    x0, x1, y0, y1 = cutout.grid_desc.extent
    e = np.linspace(x0, x1, 65), np.linspace(y0, y1, 65)
    ex = np.concatenate([e[0], e[0], np.full(65, x0), np.full(65, x1)])
    ey = np.concatenate([np.full(65, y0), np.full(65, y1), e[1], e[1]])
    cx, cy = transform_points(ex, ey, cutout.crs, excluder.crs)
    r = excluder.res
    t, (ny, nx) = traster.padded_transform_and_shape(
        (cx.min() - r, cy.min() - r, cx.max() + r, cy.max() + r), r)
    return t, ny, nx, t.c + t.a * (np.arange(nx) + 0.5), t.f + t.e * (np.arange(ny) + 0.5)


def assert_fine_masks_equal(cutout, shapes, texc, jexc):
    """The port's and JAX's fine masks of the case's lattice, pixel for
    pixel: the shapes alone, then AND NOT the exclusion mask (each package
    building its own)."""
    t, ny, nx, px, py = lattice(cutout, texc)
    geoms = texcl._as_geometry_list(shapes, 4326, texc.crs)
    edges, emask = TK.shapes_to_edges(geoms)
    jedges, jemask = JK.shapes_to_edges(jexcl._as_geometry_list(
        [jgeom(g) for g in shapes], 4326, jexc.crs))
    np.testing.assert_array_equal(edges, jedges)
    excl = texcl.build_exclusion_mask(texc, t, (ny, nx))
    np.testing.assert_array_equal(excl, jexcl.build_exclusion_mask(jexc, JAffine(*t), (ny, nx)))
    f32 = dict(dtype=torch.float32)
    args = (torch.as_tensor(edges, **f32), torch.as_tensor(emask), torch.as_tensor(px, **f32),
            torch.as_tensor(py, **f32))
    with jax.enable_x64(False):
        jargs = (jnp.asarray(edges, jnp.float32), jnp.asarray(emask), jnp.asarray(px),
                 jnp.asarray(py))
        jr = np.asarray(JK.rasterize_shapes(*jargs, row_tile=64))
        jm = np.asarray(JK._block_masks(*jargs, jnp.asarray(excl), row_tile=64))
    tr = TK.rasterize_shapes(*args).numpy()
    tm = tr & ~excl
    assert tr.shape == (len(geoms), ny, nx)
    assert int((tr != jr).sum()) == 0, "rasterized pixels differ from JAX's"
    assert int((tm != jm).sum()) == 0, "masked pixels differ from JAX's"
    assert tr.any()


def three_shapes():
    return [TG.box(1.0, 1.0, 7.5, 6.5), TG.Polygon([(2, 2), (9, 3), (6, 9)]),
            TG.Polygon([(0, 0), (10, 0), (10, 10), (0, 10)], [[(3, 3), (7, 3), (7, 7), (3, 7)]])]


def test_rasterize_shapes_matches_jax_and_host():
    shapes = three_shapes()
    edges, mask = TK.shapes_to_edges(shapes)
    px = np.arange(0.25, 10, 0.5)
    py = np.arange(9.75, 0, -0.5)  # descending like a raster
    out = TK.rasterize_shapes(torch.as_tensor(edges, dtype=torch.float32), torch.as_tensor(mask),
                              torch.as_tensor(px, dtype=torch.float32),
                              torch.as_tensor(py, dtype=torch.float32), row_tile=8).numpy()
    with jax.enable_x64(False):
        want = np.asarray(JK.rasterize_shapes(jnp.asarray(edges, jnp.float32), jnp.asarray(mask),
                                              jnp.asarray(px), jnp.asarray(py), row_tile=8))
    np.testing.assert_array_equal(out, want)
    XX, YY = np.meshgrid(px, py)
    for i, s in enumerate(shapes):
        ref = TG.points_in_polygon(s, XX.ravel(), YY.ravel()).reshape(XX.shape)
        np.testing.assert_array_equal(out[i], ref, err_msg=f"shape {i}")


def test_rasterize_shapes_any_pixel_order_and_many_edges(monkeypatch):
    """Centres in any order give the same masks; a ring of 3,000 edges and
    rows tiled to the crossing-table budget equal JAX's masks."""
    rng = np.random.default_rng(3)
    t = np.sort(rng.uniform(0, 2 * np.pi, 3000))
    r = 3.0 + rng.uniform(0, 1.5, t.size)
    ring = TG.Polygon(list(zip(5 + r * np.cos(t), 5 + r * np.sin(t))))
    shapes = three_shapes() + [ring]
    edges, mask = TK.shapes_to_edges(shapes)
    px = rng.permutation(np.arange(0.05, 10, 0.1))
    py = np.arange(9.95, 0, -0.1)
    f32 = dict(dtype=torch.float32)
    args = (torch.as_tensor(edges, **f32), torch.as_tensor(mask), torch.as_tensor(px, **f32),
            torch.as_tensor(py, **f32))
    with jax.enable_x64(False):
        want = np.asarray(JK.rasterize_shapes(jnp.asarray(edges, jnp.float32), jnp.asarray(mask),
                                              jnp.asarray(px), jnp.asarray(py), row_tile=16))
    with monkeypatch.context() as m:
        m.setattr(TK, "_TILE_ELEMS", 4 * 3000 * 7)  # tiles of 7 rows, the last one short
        got = TK.rasterize_shapes(*args, row_tile=1).numpy()
    assert int((got != want).sum()) == 0
    np.testing.assert_array_equal(got[:, :, np.argsort(px)],
                                  TK.rasterize_shapes(args[0], args[1], args[2].sort().values,
                                                      args[3]).numpy())


def test_average_downsample_and_unpack():
    rng = np.random.default_rng(4)
    masks = rng.random((3, 40, 50)) < 0.4
    Wy = traster.overlap_matrix(0.0, -0.1, 40, 0.05, -0.3, 13).astype(np.float32)
    Wx = traster.overlap_matrix(0.0, 0.1, 50, -0.02, 0.35, 15).astype(np.float32)
    got = TK.average_downsample(torch.as_tensor(masks), torch.as_tensor(Wy),
                                torch.as_tensor(Wx)).numpy()
    with jax.enable_x64(False):
        want = np.asarray(JK.average_downsample(jnp.asarray(masks), jnp.asarray(Wy),
                                                jnp.asarray(Wx)))
    np.testing.assert_allclose(got, want, atol=SAME_CRS_ATOL)
    bits = rng.random(1003) < 0.5
    np.testing.assert_array_equal(
        TK._unpack_mask_device(torch.as_tensor(np.packbits(bits)), bits.size).numpy(), bits)


def random_raster(shape, seed, frac=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < frac).astype(np.int32)


TWO = [TG.box(X0 + 1, Y0 + 1, X1 - 1, Y0 / 2 + Y1 / 2),
       TG.box(X0 + 1, Y0 / 2 + Y1 / 2, X1 - 1, Y1 - 1)]


def projected_raster(crs, res, seed):
    cx, cy = transform_points(np.array([X0 - 0.5, X0 - 0.5, X1 + 0.5, X1 + 0.5]),
                              np.array([Y0 - 0.5, Y1 + 0.5, Y0 - 0.5, Y1 + 0.5]), 4326, crs)
    t, shape = traster.padded_transform_and_shape((cx.min(), cy.min(), cx.max(), cy.max()), res)
    return random_raster(shape, seed), t


@pytest.mark.parametrize("crs", [4326, 3035, 32630], ids=["same-crs", "laea", "utm"])
def test_availability_matches_jax_and_host(pair, crs):
    """tests/test_gis_kernels.py's host-equivalence cases: a random 0/1
    raster at 0.01 deg, and at 4 km in EPSG:3035 and UTM 30N."""
    jc, tc = pair
    if crs == 4326:
        t, shape = traster.padded_transform_and_shape((X0, Y0, X1, Y1), 0.01)
        data, res, atol = random_raster(shape, 0), 0.01, SAME_CRS_ATOL
    else:
        (data, t), res, atol = projected_raster(crs, 4000.0, {3035: 1, 32630: 7}[crs]), 4000.0, \
            CROSS_CRS_ATOL
    texc, jexc = excluders(crs, res, rasters=[(data, t, crs, {})])
    assert_fine_masks_equal(tc, TWO, texc, jexc)
    dev = TK.availability_matrix_device(tc, TWO, texc)
    assert isinstance(dev, np.ndarray) and dev.shape == (2,) + tc.shape
    np.testing.assert_allclose(dev, jax_device(jc, TWO, jexc), atol=atol, rtol=0)
    t2, _ = excluders(crs, res, rasters=[(data, t, crs, {})])
    host = tc.availabilitymatrix(pd.Series(TWO).rename_axis("shape"), t2, backend="host").values
    if crs == 4326:
        np.testing.assert_allclose(dev, host, atol=HOST_ATOL)
        np.testing.assert_allclose(dev.sum(), host.sum(), rtol=1e-3)
    else:
        # whole-extent vs per-shape-padded fine lattices: close, not bitwise
        assert np.isfinite(dev).all()
        assert abs(dev.sum() - host.sum()) / host.sum() < 0.05
        np.testing.assert_allclose(dev.mean(axis=(1, 2)), host.mean(axis=(1, 2)), rtol=0.05)
    # the device backend through the Cutout member gives the same numbers
    t3, _ = excluders(crs, res, rasters=[(data, t, crs, {})])
    da = tc.availabilitymatrix(TWO, t3, backend="device")
    assert da.dims == ("shape", "y", "x")
    np.testing.assert_array_equal(da.values, dev)


def test_cache_invalidation(pair):
    """Changing a raster's codes in place must not reuse the cached mask."""
    jc, tc = pair
    rng = np.random.default_rng(2)
    data = rng.integers(0, 4, (120, 120)).astype(np.int32)
    tr = Affine(0.05, 0, X0 - 0.2, 0, -0.05, Y1 + 0.2)
    shapes = [TG.box(X0 + 1, Y0 + 1, X0 + 3, Y0 + 3)]
    texc, jexc = excluders(4326, 0.05, rasters=[(data, tr, 4326, dict(codes=[1]))])
    assert_fine_masks_equal(tc, shapes, texc, jexc)
    a1 = TK.availability_matrix_device(tc, shapes, texc)
    np.testing.assert_allclose(a1, jax_device(jc, shapes, jexc), atol=SAME_CRS_ATOL, rtol=0)
    assert texc._fine_mask_cache is not None
    texc.rasters[0]["codes"] = jexc.rasters[0]["codes"] = [1, 2, 3]
    a2 = TK.availability_matrix_device(tc, shapes, texc)
    assert a2.sum() < a1.sum()
    np.testing.assert_allclose(a2, jax_device(jc, shapes, jexc), atol=SAME_CRS_ATOL, rtol=0)


def test_geometry_exclusion(pair):
    jc, tc = pair
    shapes = [TG.box(X0, Y0, X1, Y1)]
    exclude = [TG.box(X0 / 2 + X1 / 2, Y0 / 2 + Y1 / 2, X1, Y1)]
    texc, jexc = excluders(4326, 0.01, geometries=[(exclude, {})])
    assert_fine_masks_equal(tc, shapes, texc, jexc)
    dev = TK.availability_matrix_device(tc, shapes, texc)
    np.testing.assert_allclose(dev, jax_device(jc, shapes, jexc), atol=SAME_CRS_ATOL, rtol=0)
    g = tc.grid_desc
    ne = (g.x[None, :] > (X0 + X1) / 2 + 0.2) & (g.y[:, None] > (Y0 + Y1) / 2 + 0.2)
    inside = (g.x[None, :] > X0 + 0.2) & (g.x[None, :] < (X0 + X1) / 2 - 0.2) \
        & (g.y[:, None] > Y0 + 0.2) & (g.y[:, None] < Y1 - 0.2)
    assert np.all(dev[0][ne] < 1e-6)
    assert np.all(dev[0][inside] > 0.99)


def test_streamed_blocks_equal(pair):
    """Row-block streaming (bounded device memory) equals one block, and
    JAX's streamed result."""
    jc, tc = pair
    shapes = [TG.box(-3, 57, 0, 60), TG.box(-2, 58, 1, 61)]
    texc, jexc = excluders(4326, 0.01)
    assert_fine_masks_equal(tc, shapes, texc, jexc)
    a1 = TK.availability_matrix_device(tc, shapes, texc)
    a2 = TK.availability_matrix_device(tc, shapes, excluders(4326, 0.01)[0],
                                       max_device_pixels=200_000)
    np.testing.assert_allclose(a1, a2, atol=1e-6)
    np.testing.assert_allclose(a2, jax_device(jc, shapes, jexc, max_device_pixels=200_000),
                               atol=SAME_CRS_ATOL, rtol=0)


@pytest.mark.parametrize("max_pix", [64_000_000, 150_000], ids=["one-block", "blocks"])
def test_cross_crs_streamed_blocks(pair, max_pix):
    """The cross-CRS path in row blocks, each with its cutout-row window,
    against JAX's, and one block against many."""
    jc, tc = pair
    data, t = projected_raster(3035, 2000.0, 11)
    texc, jexc = excluders(3035, 2000.0, rasters=[(data, t, 3035, {})])
    shapes = [TG.box(-3, 57, 0, 60), TG.box(-2, 58, 1, 61), TG.box(X0, Y0, X1, Y1)]
    assert_fine_masks_equal(tc, shapes, texc, jexc)
    got = TK.availability_matrix_device(tc, shapes, texc, max_device_pixels=max_pix)
    np.testing.assert_allclose(got, jax_device(jc, shapes, jexc, max_device_pixels=max_pix),
                               atol=CROSS_CRS_ATOL, rtol=0)
    one = TK.availability_matrix_device(tc, shapes, excluders(3035, 2000.0, rasters=[
        (data, t, 3035, {})])[0])
    np.testing.assert_allclose(got, one, atol=CROSS_CRS_ATOL, rtol=0)


def assert_equal_but_float32_flips(cutout, shapes, excluder, got, want, atol):
    """``got`` (the device path, which rasterizes in float64 as the host
    path does) equals ``want`` (JAX's device path, float32 crossings)
    within ``atol`` in every cell but those holding a pixel that the two
    precisions put on different sides of a shape's edge, and differs in
    no more cells than there are such pixels."""
    _, ny, nx, px, py = lattice(cutout, excluder)
    edges, emask = TK.shapes_to_edges(texcl._as_geometry_list(shapes, 4326, excluder.crs))
    masks = [TK.rasterize_shapes(torch.as_tensor(edges, dtype=dt), torch.as_tensor(emask),
                                 torch.as_tensor(px, dtype=dt), torch.as_tensor(py, dtype=dt))
             .numpy() for dt in (torch.float32, torch.float64)]
    s, r, c = np.nonzero(masks[0] != masks[1])
    lon, lat = transform_points(px[c], py[r], excluder.crs, cutout.crs)
    inv = cutout.grid_desc.transform_r.inverse
    NY = cutout.shape[0]
    rows = NY - 1 - np.floor(inv.d * lon + inv.e * lat + inv.f).astype(int)  # ascending y
    cols = np.floor(inv.a * lon + inv.b * lat + inv.c).astype(int)
    flipped = {(int(a), int(b), int(k)) for a, b, k in zip(s, rows, cols)}
    off = {tuple(int(v) for v in i) for i in np.argwhere(np.abs(got - want) > atol)}
    assert off <= flipped, sorted(off - flipped)
    assert len(off) <= len(s)
    return len(off)


def test_lcc_excluder_reproduces_laea_result(pair):
    """The same physical exclusion in EPSG:3034 (LCC) and 3035 (LAEA)
    gives the same availability, each equal to JAX's but where JAX's
    float32 crossings put a pixel on the other side of an edge (the device
    path's float64 crossings are the host path's: on this case they equal
    the host's matrix in EPSG:3034).  The cells exempted are counted: none
    in EPSG:3035, and in EPSG:3034 the one flipped pixel on the shared
    border, a cell in each of the two boxes."""
    jc, tc = pair
    t = np.linspace(0, 2 * np.pi, 100, endpoint=False)
    ex_lon, ex_lat = -1.5 + 1.8 * np.cos(t), 58.5 + 1.4 * np.sin(t)
    results, exempted = {}, {}
    for code in (3035, 3034):
        ex_x, ex_y = transform_points(ex_lon, ex_lat, 4326, code)
        texc, jexc = excluders(code, 1500.0,
                               geometries=[([TG.Polygon(list(zip(ex_x, ex_y)))], {})])
        assert_fine_masks_equal(tc, TWO, texc, jexc)
        results[code] = TK.availability_matrix_device(tc, TWO, texc)
        exempted[code] = assert_equal_but_float32_flips(
            tc, TWO, texc, results[code], jax_device(jc, TWO, jexc), CROSS_CRS_ATOL)
    assert exempted == {3035: 0, 3034: 2}
    host_exc, _ = excluders(3034, 1500.0, geometries=[([TG.Polygon(list(zip(ex_x, ex_y)))], {})])
    np.testing.assert_array_equal(results[3034], tc.availabilitymatrix(TWO, host_exc,
                                                                       backend="host").values)
    base = TK.availability_matrix_device(tc, TWO, texcl.ExclusionContainer(3035, res=1500.0))
    a, b = results[3035], results[3034]
    assert a.sum() < 0.9 * base.sum()
    np.testing.assert_allclose(b, a, atol=6e-2)
    np.testing.assert_allclose(b.sum(), a.sum(), rtol=3e-3)


def test_no_overlap_raises_as_host():
    cut = atlite_tpu_torch.Cutout(device="cpu", module="synthetic", bounds=(-4, 56, 1.5, 62),
                                  time="2013-01-01")
    far = np.ones((10, 10), np.uint8)
    texc, _ = excluders(4326, 0.1, rasters=[(far, Affine(0.01, 0, 100.0, 0, -0.01, -60.0),
                                             4326, {})])
    with pytest.raises(ValueError, match="do not overlap"):
        TK.availability_matrix_device(cut, [TG.box(-4, 56, 1.5, 62)], texc)


def test_blocked_build_with_buffered_geometry(pair, monkeypatch):
    """The cold mask is built per row block on a worker thread; a buffered
    geometry layer's dilation reaches across block edges, so the margin
    build must equal the one-block build; the warm (cached) mask, and a
    warm call with another block structure, must reproduce it."""
    jc, tc = pair
    rng = np.random.default_rng(5)
    data = rng.integers(0, 4, (130, 124)).astype(np.uint8)
    tr = Affine(0.05, 0, X0 - 0.2, 0, -0.05, Y1 + 0.2)
    exclude = [TG.box(-2.0, 58.0, -1.0, 58.5)]
    shapes = [TG.box(-3, 57, 0, 60), TG.box(-2, 58, 1, 61)]

    def make():
        return excluders(4326, 0.01, rasters=[(data, tr, 4326, dict(codes=[2]))],
                         geometries=[(exclude, dict(buffer=0.05))])

    texc, jexc = make()
    assert_fine_masks_equal(tc, shapes, texc, jexc)
    a_one = TK.availability_matrix_device(tc, shapes, make()[0])
    exc_blk = make()[0]
    real_build, builds = texcl.build_exclusion_mask, []

    def built(*args, **kwargs):
        builds.append(args[2])
        return real_build(*args, **kwargs)

    monkeypatch.setattr(texcl, "build_exclusion_mask", built)
    a_blk = TK.availability_matrix_device(tc, shapes, exc_blk, max_device_pixels=150_000)
    np.testing.assert_allclose(a_blk, a_one, atol=1e-6)
    assert len(builds) > 1  # built per block
    a_warm = TK.availability_matrix_device(tc, shapes, exc_blk, max_device_pixels=150_000)
    np.testing.assert_allclose(a_warm, a_blk, atol=1e-6)
    a_warm2 = TK.availability_matrix_device(tc, shapes, exc_blk, max_device_pixels=400_000)
    np.testing.assert_allclose(a_warm2, a_blk, atol=1e-6)
    np.testing.assert_allclose(a_blk, jax_device(jc, shapes, jexc, max_device_pixels=150_000),
                               atol=SAME_CRS_ATOL, rtol=0)


def test_native_code_mask_fast_lane_equals_value_path():
    """Sampling the precomputed native bool mask equals sampling values
    then applying codes, including invert and nodata outside the raster."""
    rng = np.random.default_rng(1)
    tr = Affine(0.05, 0, X0 + 0.8, 0, -0.05, Y1 - 0.9)
    data = rng.integers(0, 6, (60, 70)).astype(np.uint8)
    transform, shape = traster.padded_transform_and_shape((X0, Y0, X1, Y1), 0.01)
    for invert, codes, nodata in [(False, [2, 3], 255), (True, [2, 3], 255),
                                  (False, [1], 3), (True, None, 255)]:
        fast = texcl.ExclusionContainer(4326, res=0.01)
        fast.add_raster(traster.Raster(data, tr, 4326, 255), codes=codes, invert=invert,
                        nodata=nodata)
        slow = texcl.ExclusionContainer(4326, res=0.01)
        fn = ((lambda v, c=set(codes): np.isin(v, list(c))) if codes is not None
              else (lambda v: v.astype(bool)))
        slow.add_raster(traster.Raster(data, tr, 4326, 255), codes=fn, invert=invert,
                        nodata=nodata)
        np.testing.assert_array_equal(texcl.build_exclusion_mask(fast, transform, shape),
                                      texcl.build_exclusion_mask(slow, transform, shape))


def test_callable_codes_full_lattice(pair):
    """A callable code filter need not be pointwise: the device path hands
    it the full lattice in one build, so the result does not depend on
    the block size, warm equals cold, and a pointwise callable matches
    JAX's device path and the host path."""
    jc, tc = pair
    rng = np.random.default_rng(9)
    data = rng.random((130, 124)).astype(np.float32)
    tr = Affine(0.05, 0, X0 - 0.2, 0, -0.05, Y1 + 0.2)

    def codes(a):
        return a > np.quantile(a, 0.7)  # global state: not pointwise

    shapes = [TG.box(-3, 57, 0, 60)]

    def run(max_pix):
        exc = texcl.ExclusionContainer(4326, res=0.01)
        exc.add_raster(traster.Raster(data, tr, 4326, -1.0), codes=codes, nodata=-1.0)
        a = TK.availability_matrix_device(tc, shapes, exc, max_device_pixels=max_pix)
        warm = TK.availability_matrix_device(tc, shapes, exc, max_device_pixels=max_pix)
        np.testing.assert_allclose(warm, a, atol=1e-7)
        return a

    np.testing.assert_allclose(run(150_000), run(64_000_000), atol=1e-7)

    def pointwise(a):
        return a > 0.7

    texc, jexc = excluders(4326, 0.01, rasters=[(data, tr, 4326, dict(codes=pointwise,
                                                                      nodata=-1.0))])
    assert_fine_masks_equal(tc, shapes, texc, jexc)
    dev = TK.availability_matrix_device(tc, shapes, texc, max_device_pixels=150_000)
    np.testing.assert_allclose(dev, jax_device(jc, shapes, jexc, max_device_pixels=150_000),
                               atol=SAME_CRS_ATOL, rtol=0)
    h = texcl.ExclusionContainer(4326, res=0.01)
    h.add_raster(traster.Raster(data, tr, 4326, -1.0), codes=pointwise, nodata=-1.0)
    host = texcl.compute_availabilitymatrix(tc, shapes, h, backend="host").values
    np.testing.assert_allclose(dev, host, atol=1e-6)


def test_mesh_waits_for_the_multi_gpu_slice(pair):
    """The multi-GPU slice has come: ``mesh=`` takes a ``core.mesh.Mesh``
    (two devices here; the sharded cases of tests/test_gis_kernels.py are
    in tests/test_torch_sharded_cutout.py) and refuses anything else."""
    from atlite_tpu_torch.core.mesh import make_mesh

    _, tc = pair
    with pytest.raises(TypeError, match="Mesh"):
        TK.availability_matrix_device(tc, TWO, texcl.ExclusionContainer(4326, res=0.01),
                                      mesh=object())
    want = TK.availability_matrix_device(tc, TWO, texcl.ExclusionContainer(4326, res=0.01))
    got = TK.availability_matrix_device(tc, TWO, texcl.ExclusionContainer(4326, res=0.01),
                                        mesh=make_mesh([torch.device("cpu")] * 2))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# --- the shapes' windows, buffered raster layers on the device ---------

RES = 1000.0


def class_raster(seed, share=0.03):
    """A uint8 class raster on the RES lattice in EPSG:3035 around the
    cutout (aligned, so the device samples it): class 20 (eligible), a
    ``share`` of classes 1-6, and its pixel centres in lon/lat."""
    x, y = transform_points(np.array([X0 - 1, X0 - 1, X1 + 1, X1 + 1]),
                            np.array([Y0 - 1, Y1 + 1, Y0 - 1, Y1 + 1]), 4326, 3035)
    t, shape = traster.padded_transform_and_shape((x.min(), y.min(), x.max(), y.max()), RES)
    rng = np.random.default_rng(seed)
    data = np.full(shape, 20, np.uint8)
    hit = rng.random(shape) < share
    data[hit] = rng.integers(1, 7, int(hit.sum()))
    cx = t.c + t.a * (np.arange(shape[1]) + 0.5)
    cy = t.f + t.e * (np.arange(shape[0]) + 0.5)
    lon, lat = transform_points(np.broadcast_to(cx, shape).ravel(),
                                np.broadcast_to(cy[:, None], shape).ravel(), 3035, 4326)
    return data, t, lon.reshape(shape), lat.reshape(shape)


def shared_border():
    data, t, lon, lat = class_raster(0, share=0.0)
    # classes 1-6 in a strip inside the western shape, along the border
    data[(lon > -1.03) & (lon < -1.0) & (lat > 57.2) & (lat < 59.8)] = 3
    return [TG.box(-3, 57, -1, 60), TG.box(-1, 57, 1, 60)], \
        [(data, t, dict(codes=[1, 2, 3, 4, 5, 6], buffer=3000))]


def invert_buffer():
    data, t, _, _ = class_raster(1)
    return [TG.box(-3, 57, 0, 60)], [(data, t, dict(codes=[20], invert=True, buffer=2000))]


def overlapping():
    data, t, _, _ = class_raster(2, share=0.05)
    natura = (np.random.default_rng(3).random(data.shape) < 0.1).astype(np.uint8)
    return [TG.box(-3, 57, 0, 60), TG.box(-1.5, 58, 1, 61)], \
        [(natura, t, dict(nodata=0, allow_no_overlap=True)),
         (data, t, dict(codes=list(range(12, 30)), invert=True)),
         (data, t, dict(codes=[1, 2, 3, 4, 5, 6], buffer=3000))]


def narrow():
    data, t, _, _ = class_raster(4, share=0.1)
    return [TG.box(-2, 57, -1.98, 60), TG.box(-1.98, 57, 0, 60)], \
        [(data, t, dict(codes=[1, 2, 3, 4, 5, 6], buffer=3000))]


def lattice_edge():
    data, t, lon, lat = class_raster(5, share=0.0)
    # classes 1-6 along the shape's own edges: the dilation reaches the
    # window's edges
    edge = (np.abs(lon - X0) < 0.02) | (np.abs(lat - Y0) < 0.02) \
        | (np.abs(lon - (X0 + 1.5)) < 0.02) | (np.abs(lat - (Y0 + 1.5)) < 0.02)
    data[edge] = 1
    return [TG.box(X0, Y0, X0 + 1.5, Y0 + 1.5)], [(data, t, dict(codes=[1], buffer=3000))]


def host_layers():
    """Layers the device does not sample: a buffered int32 raster (built
    on the host window by window) and an unaligned unbuffered one (the
    shared host mask), beside a device layer."""
    data, t, _, _ = class_raster(6, share=0.05)
    shifted = Affine(t.a, 0, t.c + 300.0, 0, t.e, t.f)
    return [TG.box(-3, 57, 0, 60), TG.box(-1.5, 58, 1, 61)], \
        [(data.astype(np.int32), t, dict(codes=[1, 2, 3], buffer=2000)),
         (data, shifted, dict(codes=[4, 5])),
         (data, t, dict(codes=[6], buffer=1000))]


WINDOW_CASES = {"shared-border": shared_border, "invert-buffer": invert_buffer,
                "overlapping": overlapping, "narrow": narrow, "lattice-edge": lattice_edge,
                "host-layers": host_layers}


def window_excluders(layers):
    return excluders(3035, RES, rasters=[(d, t, 3035, kw) for d, t, kw in layers])


def window_masks(geoms, excluder, device="cpu", row_tile=64):
    """[(transform, available, excluded)] of each shape (in the excluder's
    CRS) on its own window, as the device path makes them: numpy bool
    (ny, nx) masks, the window's transform the host path's
    (``shape_availability``, ``build_exclusion_mask`` with its crop)."""
    if not excluder.all_open:
        excluder.open_files()
    device = torch.device(device)
    res = excluder.res
    wins = [traster.padded_transform_and_shape(g.bounds, res) for g in geoms]
    b = np.array([(t.c, t.f + t.e * n[0], t.c + t.a * n[1], t.f) for t, n in wins])
    tL, (nyL, nxL) = traster.padded_transform_and_shape(
        (b[:, 0].min(), b[:, 1].min(), b[:, 2].max(), b[:, 3].max()), res)
    layers = TK._prepare_layers(excluder, tL, nyL, nxL, device, row_tile, 64_000_000)
    out = []
    for k, (geom, (t, n)) in enumerate(zip(geoms, wins)):
        inside, excl, _, _ = TK._window_masks([geom], [(t, n)], [k], layers, res, device,
                                              row_tile)
        inside, excl = inside[0].cpu().numpy(), excl[0].cpu().numpy()
        out.append((t, inside & ~excl, excl))
    return out


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_buffered_windows_equal_the_host_path(pair, case):
    """The device path's windows against the host path: each shape's fine
    masks pixel for pixel (available pixels; with only device layers the
    exclusion mask of ``build_exclusion_mask`` with the crop too), and the
    availability matrix within HOST_ATOL of the port's and the JAX
    package's host paths."""
    jc, tc = pair
    shapes, layers = WINDOW_CASES[case]()
    texc, _ = window_excluders(layers)
    dev = TK.availability_matrix_device(tc, shapes, texc)
    host = tc.availabilitymatrix(shapes, window_excluders(layers)[0], backend="host").values
    np.testing.assert_allclose(dev, host, rtol=0, atol=HOST_ATOL)
    want = jc.availabilitymatrix(pd.Series([jgeom(g) for g in shapes]).rename_axis("shape"),
                                 window_excluders(layers)[1], backend="host")
    np.testing.assert_allclose(dev, np.asarray(want.values), rtol=0, atol=HOST_ATOL)
    all_device = all(TK._device_layer(d, RES, 3035) for d in texc.rasters)
    assert all_device == (case != "host-layers")
    geoms = texcl._as_geometry_list(shapes, 4326, 3035)
    for (t, avail, excl), g in zip(window_masks(geoms, window_excluders(layers)[0]), geoms):
        want_avail, wt = texcl.shape_availability([g], window_excluders(layers)[0], 3035)
        assert tuple(t) == tuple(wt)
        assert int((avail != want_avail).sum()) == 0, "available pixels differ from the host's"
        if all_device:
            want_excl = texcl.build_exclusion_mask(window_excluders(layers)[0], wt, avail.shape,
                                                   crop_geoms=[g])
            assert int((excl != want_excl).sum()) == 0, "excluded pixels differ from the host's"
    assert host.sum() > 0
    if case == "shared-border":
        # the strip buffers into the western shape only
        free = TK.availability_matrix_device(tc, shapes, texcl.ExclusionContainer(3035, res=RES))
        np.testing.assert_array_equal(dev[1], free[1])
        assert dev[0].sum() < free[0].sum() - 0.5


@pytest.mark.parametrize("crs", [4326, 3035], ids=["same-crs", "laea"])
def test_windowed_lattice_equals_the_full_extent(pair, crs):
    """On unbuffered layers the windowed lattice (the shapes' windows and
    the whole cells they touch, far smaller than the cutout's extent)
    gives the result of one lattice over the extent: the JAX package's
    device path, within its tolerance."""
    jc, tc = pair
    shapes = [TG.box(-3.0, 57.0, -2.0, 58.5), TG.box(-2.5, 58.0, -1.5, 59.0)]
    if crs == 4326:
        t, shape = traster.padded_transform_and_shape((X0, Y0, X1, Y1), 0.01)
        rasters, res, atol = [(random_raster(shape, 8).astype(np.uint8), t, 4326, {}),
                              (random_raster(shape, 9), t, 4326, {})], 0.01, SAME_CRS_ATOL
    else:
        data, t = projected_raster(3035, 2000.0, 12)
        rasters, res, atol = [(data.astype(np.uint8), t, 3035, {}),
                              (data, t, 3035, dict(codes=[0]))], 2000.0, CROSS_CRS_ATOL
    texc, jexc = excluders(crs, res, rasters=rasters)
    before = TK.availability_matrix_device.window_pixels
    got = TK.availability_matrix_device(tc, shapes, texc)
    worked = TK.availability_matrix_device.window_pixels - before
    np.testing.assert_allclose(got, jax_device(jc, shapes, jexc), atol=atol, rtol=0)
    _, ny, nx, _, _ = lattice(tc, texc)
    assert 0 < worked < ny * nx / 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_counts_equal_pixel_counts(seed):
    """A window's available pixels are counted per cell from the prefix
    sums along its rows at the ends of its runs of one cell: the counts
    must equal counting the pixels cell by cell, for runs of any length,
    ids repeating along a row, and padded windows."""
    rng = np.random.default_rng(seed)
    S, ny, nx, bins = 3, 17, 29, 12
    # runs: a cell id that changes at random columns of each row
    ids = np.cumsum(rng.random((S, ny, nx)) < 0.2, axis=2) % (bins - 1)
    ids[:, :, -3:] = bins - 1  # padding: the overflow bin
    avail = rng.random((S, ny, nx)) < 0.6
    num = torch.zeros((5, bins), dtype=torch.int64)
    sel = torch.tensor([4, 0, 2])
    TK._count_runs(num, sel, torch.as_tensor(avail), torch.as_tensor(ids, dtype=torch.int32))
    for k, s in enumerate(sel.tolist()):
        np.testing.assert_array_equal(num[s].numpy(), np.bincount(ids[k].ravel(),
                                                                  weights=avail[k].ravel(),
                                                                  minlength=bins))
    assert num[[1, 3]].sum() == 0


def test_window_counters(pair):
    """``shape_windows`` counts the windows a call works, ``window_pixels``
    their fine pixels (the host path's own lattices)."""
    _, tc = pair
    shapes, layers = overlapping()
    exc, _ = window_excluders(layers)
    f = TK.availability_matrix_device
    n0, p0 = f.shape_windows, f.window_pixels
    TK.availability_matrix_device(tc, shapes, exc)
    wins = [traster.padded_transform_and_shape(g.bounds, RES)[1]
            for g in texcl._as_geometry_list(shapes, 4326, 3035)]
    assert f.shape_windows - n0 == 2
    assert f.window_pixels - p0 == sum(a * b for a, b in wins)


def test_spans_of_a_call(pair, monkeypatch):
    """Under a profiler a call opens ``aggregate <s0>:<s1>`` around each
    batch of windows, ``copy <r0>:<r1>`` around each raster upload, ``pack
    <r0>:<r1>`` around the cell lattice and ``mask <s0>:<s1>`` around each
    host build of a window; with no profiler it enters no range."""
    import re

    from torch.profiler import ProfilerActivity, profile

    _, tc = pair
    shapes, layers = host_layers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        TK.availability_matrix_device(tc, shapes, window_excluders(layers)[0])
    names = [e.name for e in prof.events()]
    assert "aggregate 0:2" in names
    for step in ("copy", "pack", "mask"):
        assert any(re.match(rf"^{step} \d+:\d+$", n) for n in names), step
    entered = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: entered.append(name))
    TK.availability_matrix_device(tc, shapes, window_excluders(layers)[0])
    assert entered == []


def test_port_against_the_plain_reference():
    """The benchmark's plain float64 reference (``h100_bench/reference/
    availability.py``) and the device path on the CPU agree at a small
    size, within the benchmark's limit, on PyPSA-Eur's three layers; the
    reference without the crop does not."""
    import copy
    import json
    from pathlib import Path

    from h100_bench.harness import named
    from h100_bench.harness.session import Session

    root = Path(__file__).resolve().parents[1]
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == "eur03-avail")
    config = json.loads((root / "h100_bench/configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((root / "h100_bench/traffic" / f"{cell['traffic']}.json").read_text())
    config = copy.deepcopy(config)
    config["regions"].update(bounds=[9.0, 50.0, 9.6, 50.5], ny=2, nx=2, edge_vertices=9)
    session = Session(config, traffic, 2**31 + 11, "cpu")
    got = session.calls[0][1]()
    ref = named.module("reference", "availability")
    cpu = torch.device("cpu")
    want = ref.matrix(session.inputs, config, torch.float64, cpu).numpy()
    gap = np.linalg.norm(got - want) / np.linalg.norm(want)
    limit = session.entry.limit(session, "avail")
    assert gap < limit / 5, gap
    no_crop = ref.matrix(session.inputs, config, torch.float64, cpu, crop=False).numpy()
    assert np.linalg.norm(no_crop - want) / np.linalg.norm(want) > limit


@pytest.mark.parametrize("crs", [3035, 32630, 3034, 2154, 3857, "cea", 27700, 31370, 3413, 25832,
                                 "+proj=cea +lat_ts=30 +ellps=WGS84"])
def test_crs_math_under_torch(crs):
    """``transform_points_xp(..., torch)``, the device path's CRS math, in
    float32 on the tensors' device, forward and inverse, against the JAX
    package's under jax.numpy with x64 off and against the float64 host
    transform: within 2e-6 relative (16 float32 ulps; XLA's and PyTorch's
    float32 sin/arcsin/arctan2 round apart by a few)."""
    from atlite_tpu.gis import crs as jcrs
    from atlite_tpu_torch.gis import crs as tcrs

    rng = np.random.default_rng(0)
    lon, lat = rng.uniform(-10, 20, 2000), rng.uniform(36, 62, 2000)
    X, Y = tcrs.transform_points(lon, lat, 4326, crs)
    for src, dst, (a, b) in ((4326, crs, (lon, lat)), (crs, 4326, (X, Y))):
        ta, tb = torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(b, dtype=torch.float32)
        got = tcrs.transform_points_xp(ta, tb, src, dst, torch)
        with jax.enable_x64(False):
            want = jcrs.transform_points_xp(jnp.asarray(a), jnp.asarray(b), src, dst, jnp)
        host = tcrs.transform_points(a, b, src, dst)
        for g, w, h in zip(got, want, host):
            assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
            g = g.reshape(-1).numpy()
            scale = np.abs(h).max()
            np.testing.assert_allclose(g, np.asarray(w).reshape(-1), rtol=0, atol=2e-6 * scale)
            np.testing.assert_allclose(g, h, rtol=0, atol=2e-6 * scale)
