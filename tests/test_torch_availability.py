"""The port's device path of the availability matrix
(``gis.kernels.availability_matrix_device``), run on the CPU, against the
JAX package's device path (``atlite_tpu.gis.kernels``, JAX on the CPU with
x64 off, float32 as on its chip), on the cases of tests/test_gis_kernels.py
(its two shape-sharded ones, ``mesh=``, are in
tests/test_torch_sharded_cutout.py).

On every case the fine masks themselves are compared: the rasterized
shapes (``rasterize_shapes``) and the shapes AND NOT the exclusion mask
(``_block_masks``) on the case's whole fine lattice must be equal pixel
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
    tm = TK._block_masks(*args, torch.as_tensor(excl)).numpy()
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


def test_lcc_excluder_reproduces_laea_result(pair):
    """The same physical exclusion in EPSG:3034 (LCC) and 3035 (LAEA)
    gives the same availability, each equal to JAX's."""
    jc, tc = pair
    t = np.linspace(0, 2 * np.pi, 100, endpoint=False)
    ex_lon, ex_lat = -1.5 + 1.8 * np.cos(t), 58.5 + 1.4 * np.sin(t)
    results = {}
    for code in (3035, 3034):
        ex_x, ex_y = transform_points(ex_lon, ex_lat, 4326, code)
        texc, jexc = excluders(code, 1500.0,
                               geometries=[([TG.Polygon(list(zip(ex_x, ex_y)))], {})])
        assert_fine_masks_equal(tc, TWO, texc, jexc)
        results[code] = TK.availability_matrix_device(tc, TWO, texc)
        np.testing.assert_allclose(results[code], jax_device(jc, TWO, jexc),
                                   atol=CROSS_CRS_ATOL, rtol=0)
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


def test_blocked_build_with_buffered_geometry(pair):
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
    a_blk = TK.availability_matrix_device(tc, shapes, exc_blk, max_device_pixels=150_000)
    np.testing.assert_allclose(a_blk, a_one, atol=1e-6)
    assert len(exc_blk._fine_mask_cache[1]) > 1  # cached per block
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


def test_dropped_pixels_redo_the_block_on_the_host(pair, monkeypatch, caplog):
    """Where a block's sampled row window misses in-cutout pixels, the
    block's device counts are taken out and the block is redone by the
    exact host scatter: the result equals the one with the right windows."""
    _, tc = pair
    data, t = projected_raster(3035, 4000.0, 1)
    shapes = TWO
    want = TK.availability_matrix_device(tc, shapes, excluders(3035, 4000.0, rasters=[
        (data, t, 3035, {})])[0], max_device_pixels=10_000)
    real = TK._block_cells_crosscrs
    calls = []

    def narrow(*args, **kw):
        calls.append(1)
        if len(calls) == 2:  # one block's window a row short at the top
            args = args[:6] + (args[6] + 5,) + args[7:]
        return real(*args, **kw)

    monkeypatch.setattr(TK, "_block_cells_crosscrs", narrow)
    with caplog.at_level("WARNING", logger="atlite_tpu_torch.gis.kernels"):
        got = TK.availability_matrix_device(tc, shapes, excluders(3035, 4000.0, rasters=[
            (data, t, 3035, {})])[0], max_device_pixels=10_000)
    assert len(calls) > 2 and "falling back to host scatter" in caplog.text
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_counts_equal_pixel_counts(seed):
    """The cross-CRS contraction counts runs of one cell along each row
    from the shapes' crossings and the prefix count of available pixels,
    never making the per-shape pixel mask: its counts must equal counting
    the pixel mask (``_block_masks``) cell by cell, for shapes with odd and
    even edge counts, holes, parts, and edges beyond the lattice."""
    rng = np.random.default_rng(seed)
    cut = atlite_tpu_torch.Cutout(device="cpu", module="synthetic", bounds=(-4, 56, 1.5, 62),
                                  time="2013-01-01")
    g = cut.grid_desc
    t0 = traster.padded_transform_and_shape((3.40e6, 3.70e6, 3.90e6, 4.30e6), 5000.0)[0]
    ny, nx = 120, 100
    px = t0.c + t0.a * (np.arange(nx) + 0.5)
    py = t0.f + t0.e * (np.arange(ny) + 0.5)

    def ring(cx, cy, r, n):
        a = np.sort(rng.uniform(0, 2 * np.pi, n))
        rr = r * rng.uniform(0.6, 1.0, n)
        return list(zip(cx + rr * np.cos(a), cy + rr * np.sin(a)))

    shapes = [TG.Polygon(ring(3.6e6, 4.0e6, 2.5e5, 7)),
              TG.Polygon(ring(3.7e6, 3.9e6, 4e5, 40), [ring(3.7e6, 3.9e6, 8e4, 5)]),
              TG.MultiPolygon([TG.Polygon(ring(3.5e6, 3.8e6, 9e4, 3)),
                               TG.Polygon(ring(3.8e6, 4.2e6, 1.2e5, 6))]),
              TG.box(3.3e6, 3.6e6, 4.0e6, 4.4e6)]
    edges, emask = TK.shapes_to_edges(shapes)
    f32 = dict(dtype=torch.float32)
    args = (torch.as_tensor(edges, **f32), torch.as_tensor(emask), torch.as_tensor(px, **f32),
            torch.as_tensor(py, **f32), torch.as_tensor(rng.random((ny, nx)) < 0.3))
    inv = g.transform_r.inverse
    inv_affine = torch.tensor([inv.a, inv.b, inv.c, inv.d, inv.e, inv.f], **f32)
    NY, NX = g.shape
    bins = NY * NX + 1
    kw = dict(src_crs=3035, dst_crs=4326, NX=NX, NY=NY, bins=bins)
    num, cnt, dropped = TK._block_cells_crosscrs(*args, inv_affine, 0, **kw)
    lid, _ = TK._cell_ids(args[2], args[3], inv_affine, 0, **kw)
    fine = TK._block_masks(*args).reshape(len(shapes), -1).numpy()
    lid = lid.reshape(-1).numpy()
    assert int(dropped) == 0 and (lid < bins - 1).mean() > 0.5
    for s in range(len(shapes)):
        np.testing.assert_array_equal(num[s].numpy(),
                                      np.bincount(lid, weights=fine[s], minlength=bins))
    np.testing.assert_array_equal(cnt.numpy(), np.bincount(lid, minlength=bins))


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
