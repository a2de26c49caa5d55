"""``Cutout.shard``/``unshard`` of the port on a mesh of 8 CPU devices
(``make_mesh([torch.device("cpu")] * 8)``: t=4, x=2) against the
unsharded cutout and, on the cases of tests/test_sharding.py (wind, PV,
wind by shapes), against the JAX package's sharded Cutout on its 8 virtual
CPU devices (x64 off, float32 as on its chip); then the converters the
sharded path cuts by the streamer's rules (heat demand at day edges,
smoothed runoff, CSP, a tracking mode), the refusals of ``time_chunk``
and ``stream_pack`` with JAX's messages, and ``availabilitymatrix(...,
mesh=)`` against no mesh and against JAX's ``mesh=`` on the cases of
tests/test_gis_kernels.py.

Tolerances: sharded against unsharded, gridded within 1e-6 * max (in
fact bit for bit: the blocks run the same elementwise chains) and
aggregated within 1e-5 * max (each block's partial series add in another
order); against JAX within 1e-5 * max; availability within 1e-6, as
tests/test_gis_kernels.py holds JAX's sharded path.  The grid has 24
columns, so x splits in two, and 48 hours, so t splits in four (the
demand converter in two, at the day edge).
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import atlite_tpu
from atlite_tpu.core import mesh as jmesh
from atlite_tpu.gis import geometry as JG
from atlite_tpu.gis import kernels as JK
from atlite_tpu.gis.exclusion import ExclusionContainer as JExclusionContainer
from atlite_tpu_torch import Cutout, ExclusionContainer
from atlite_tpu_torch.core.mesh import ShardedTensor, make_mesh
from atlite_tpu_torch.gis import kernels as TK
from atlite_tpu_torch.gis.geometry import box

torch.set_num_threads(1)

CPU = torch.device("cpu")
GRID_TOL = 1e-6
AGG_TOL = 1e-5
KW = dict(module="synthetic", x=slice(-4, 1.76), y=slice(56, 62),
          time=slice("2013-06-01", "2013-06-02"))
FEATURES = ["wind", "influx", "temperature", "height", "runoff"]

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def within(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = max(np.abs(want[ok]).max(), 1e-30) if ok.any() else 1.0
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=tol * scale)


@pytest.fixture(scope="module")
def cuts():
    """(port cutout, the same sharded, JAX cutout, a matrix)."""
    plain = Cutout(device="cpu", **KW).prepare(features=FEATURES)
    sharded = Cutout(device="cpu", **KW).prepare(features=FEATURES)
    sharded.shard(make_mesh([CPU] * 8))
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **KW).prepare(features=FEATURES)
    C = plain.shape[0] * plain.shape[1]
    m = sp.random(5, C, density=0.3, random_state=7, format="csr", dtype=np.float32)
    return plain, sharded, jc, m


def jax_sharded(jc, fn):
    with jax.enable_x64(False):
        jc.shard(jmesh.make_mesh(jax.devices()[:8]))
        try:
            return np.asarray(fn(jc).values)
        finally:
            jc.unshard()


def test_the_grid_splits_on_both_axes(cuts):
    _, sharded, _, _ = cuts
    assert sharded.shape == (25, 24) and len(sharded.grid_desc.time) == 48
    f = sharded.fields()
    assert isinstance(f["wnd100m"], ShardedTensor)
    assert f["wnd100m"].parts == (4, 1, 2) and f["height"].parts == (1, 2)
    subs = sharded._shard_cutouts()
    assert len(subs) == 8 and subs[(3, 1)].shape == (25, 12)
    assert len(subs[(3, 1)].grid_desc.time) == 12
    for name in ("wnd100m", "height", "solar_altitude_sin"):
        np.testing.assert_array_equal(f[name].gather().numpy(),
                                      cuts[0].fields()[name].numpy())


WIND = dict(turbine="Vestas_V112_3MW")
PV = dict(panel="CSi", orientation="latitude_optimal")


@pytest.mark.parametrize("method, kw", [("wind", WIND), ("pv", PV)], ids=["wind", "pv"])
@pytest.mark.parametrize("aggregated", [False, True], ids=["gridded", "matrix"])
def test_sharded_converters_match_unsharded_and_jax(cuts, method, kw, aggregated):
    """JAX's test_sharded_cutout_converters_match."""
    plain, sharded, jc, m = cuts
    extra = dict(matrix=m) if aggregated else {}
    got = getattr(sharded, method)(aggregate_time=None, **kw, **extra)
    want = getattr(plain, method)(aggregate_time=None, **kw, **extra)
    assert got.dims == want.dims and got.name == want.name and got.attrs == want.attrs
    for d in want.coords:
        np.testing.assert_array_equal(np.asarray(got.coords[d]), np.asarray(want.coords[d]))
    within(got.values, want.values, AGG_TOL if aggregated else GRID_TOL)
    if not aggregated:
        np.testing.assert_array_equal(got.values, want.values)
    jwant = jax_sharded(jc, lambda c: getattr(c, method)(aggregate_time=None, **kw, **extra))
    within(got.values, jwant, AGG_TOL)


def test_sharded_aggregation_by_shapes(cuts):
    """JAX's test_sharded_cutout_aggregation: regions across the x split."""
    plain, sharded, jc, _ = cuts
    shapes = [box(-4, 56, -1, 62), box(-1, 56, 1.5, 62)]
    got = sharded.wind("Vestas_V112_3MW", shapes=shapes, aggregate_time=None)
    within(got.values, plain.wind("Vestas_V112_3MW", shapes=shapes, aggregate_time=None).values,
           AGG_TOL)
    jshapes = [JG.box(-4, 56, -1, 62), JG.box(-1, 56, 1.5, 62)]
    within(got.values, jax_sharded(jc, lambda c: c.wind("Vestas_V112_3MW", shapes=jshapes,
                                                        aggregate_time=None)), AGG_TOL)


@pytest.mark.parametrize("aggregate_time", ["sum", "mean"])
def test_per_unit_capacity_and_time_aggregation(cuts, aggregate_time):
    plain, sharded, _, m = cuts
    kw = dict(matrix=m, per_unit=True, return_capacity=True, aggregate_time=aggregate_time)
    got, cap = sharded.wind("Vestas_V112_3MW", **kw)
    want, wcap = plain.wind("Vestas_V112_3MW", **kw)
    np.testing.assert_array_equal(cap.values, wcap.values)
    assert got.attrs["units"] == "p.u." and got.dims == want.dims
    within(got.values, want.values, AGG_TOL)


@pytest.mark.parametrize("aggregated", [False, True], ids=["gridded", "matrix"])
def test_day_aligned_demand_splits_at_day_edges(cuts, aggregated):
    plain, sharded, _, m = cuts
    extra = dict(matrix=m) if aggregated else {}
    got = sharded.heat_demand(hour_shift=3.0, aggregate_time=None, **extra)
    want = plain.heat_demand(hour_shift=3.0, aggregate_time=None, **extra)
    assert got.sizes["time"] == want.sizes["time"] == 3  # the shift makes a third day
    np.testing.assert_array_equal(got.coords["time"], want.coords["time"])
    within(got.values, want.values, AGG_TOL if aggregated else GRID_TOL)


def test_smoothed_runoff(cuts):
    plain, sharded, _, m = cuts
    kw = dict(matrix=m, smooth=12, lower_threshold_quantile=True, aggregate_time=None)
    within(sharded.runoff(**kw).values, plain.runoff(**kw).values, AGG_TOL)


@pytest.mark.parametrize("technology", ["solar tower", "parabolic trough"])
def test_csp(cuts, technology):
    plain, sharded, _, m = cuts
    kw = dict(installation="SAM_solar_tower", technology=technology, aggregate_time=None)
    within(sharded.csp(**kw).values, plain.csp(**kw).values, GRID_TOL)
    within(sharded.csp(matrix=m, **kw).values, plain.csp(matrix=m, **kw).values, AGG_TOL)


@pytest.mark.parametrize("tracking", ["horizontal", "dual"])
def test_tracking_pv(cuts, tracking):
    plain, sharded, _, m = cuts
    kw = dict(panel="CSi", orientation={"slope": 30.0, "azimuth": 180.0}, tracking=tracking,
              matrix=m, aggregate_time=None)
    within(sharded.pv(**kw).values, plain.pv(**kw).values, AGG_TOL)


def test_streaming_is_refused_with_jax_messages(cuts):
    _, sharded, jc, m = cuts
    for kw in (dict(time_chunk=12), dict(time_chunk=12, stream_pack="int16"),
               dict(stream_pack="int16")):
        with pytest.raises(ValueError) as want:
            jax_sharded(jc, lambda c: c.wind("Vestas_V112_3MW", matrix=m,
                                              aggregate_time=None, **kw))
        with pytest.raises(ValueError) as got:
            sharded.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None, **kw)
        assert str(got.value) == str(want.value)
        assert "unshard()" in str(got.value)


def test_a_stored_chunk_size_is_ignored(cuts):
    plain, _, _, m = cuts
    c = Cutout(device="cpu", **KW, chunksize_time=12).prepare(features=["wind"])
    assert c.chunks == {"time": 12}
    c.shard(make_mesh([CPU] * 8))
    within(c.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None).values,
           plain.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None).values, AGG_TOL)


def test_unshard_restores_the_single_device_results(cuts):
    plain, _, _, m = cuts
    c = Cutout(device="cpu", **KW).prepare(features=["wind"])
    want = plain.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None).values
    assert c.shard(make_mesh([CPU] * 4)) is c
    c.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None)
    assert c.unshard() is c
    assert isinstance(c.fields()["wnd100m"], torch.Tensor)
    np.testing.assert_array_equal(c.wind("Vestas_V112_3MW", matrix=m,
                                         aggregate_time=None).values, want)
    # streaming works again (chunks sum in another order: within the tolerance)
    within(c.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None, time_chunk=12).values,
           want, AGG_TOL)


def test_shard_refuses_what_is_not_a_local_mesh(cuts):
    c = Cutout(device="cpu", **KW)
    with pytest.raises(TypeError, match="Mesh"):
        c.shard(object())
    mesh = make_mesh([CPU] * 4)
    mesh.process_count = 2
    with pytest.raises(ValueError, match="from_store"):
        c.shard(mesh)


def test_line_rating_on_a_sharded_cutout(cuts):
    plain, sharded, _, _ = cuts
    from atlite_tpu_torch.gis.geometry import LineString

    lines = [LineString([(-3.5, 57.0), (0.5, 57.2)]), LineString([(-1.0, 56.5), (1.2, 61.0)])]
    within(sharded.line_rating(lines, 1e-4).values, plain.line_rating(lines, 1e-4).values,
           GRID_TOL)


# ------------------------------------------------------ availability
SHARDED_CASES = {
    "eight": [(-3.8 + 0.6 * i, 56.2, -3.3 + 0.6 * i, 61.5) for i in range(8)],
    "five_indivisible": [(-3.8 + 0.9 * i, 56.2, -3.1 + 0.9 * i, 61.5) for i in range(5)],
}


@pytest.fixture(scope="module")
def avail_pair():
    kw = dict(module="synthetic", bounds=(-4, 56, 1.5, 62), time="2013-01-01")
    return atlite_tpu.Cutout(path=None, **kw), Cutout(device="cpu", **kw)


@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_availability_over_a_mesh(avail_pair, case):
    """tests/test_gis_kernels.py's two shape-sharded cases."""
    jc, tc = avail_pair
    boxes = SHARDED_CASES[case]
    mesh = make_mesh([CPU] * 8)
    one = TK.availability_matrix_device(tc, [box(*b) for b in boxes],
                                        ExclusionContainer(4326, res=0.01))
    got = TK.availability_matrix_device(tc, [box(*b) for b in boxes],
                                        ExclusionContainer(4326, res=0.01), mesh=mesh)
    assert got.shape == (len(boxes), 25, 23)
    np.testing.assert_allclose(got, one, atol=1e-6, rtol=0)
    with jax.enable_x64(False):
        want = np.asarray(JK.availability_matrix_device(
            jc, [JG.box(*b) for b in boxes], JExclusionContainer(4326, res=0.01),
            mesh=jmesh.make_mesh(jax.devices()[:8])))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    via_cutout = tc.availabilitymatrix([box(*b) for b in boxes],
                                       ExclusionContainer(4326, res=0.01), mesh=mesh)
    np.testing.assert_allclose(via_cutout.values, one, atol=1e-6, rtol=0)


def test_availability_over_a_mesh_across_crs(avail_pair):
    """A 4 km EPSG:3035 raster layer (the cross-CRS counts), 3 shapes over
    8 devices: most devices hold only padding."""
    _, tc = avail_pair
    from atlite_tpu_torch.core.grid import Affine
    from atlite_tpu_torch.gis.raster import Raster

    data = np.random.default_rng(3).integers(1, 6, (180, 120), dtype=np.uint8)
    raster = Raster(data, Affine(4000.0, 0, 3.0e6, 0, -4000.0, 4.3e6), 3035, 255)

    def exc():
        e = ExclusionContainer(3035, res=4000.0)
        e.add_raster(raster, codes=[4, 5], allow_no_overlap=True)
        return e

    shapes = [box(-3.5, 56.5, -1.0, 60.0), box(-1.5, 57.0, 1.0, 61.5), box(-4, 56, 1.5, 62)]
    one = TK.availability_matrix_device(tc, shapes, exc())
    got = TK.availability_matrix_device(tc, shapes, exc(), mesh=make_mesh([CPU] * 8))
    np.testing.assert_allclose(got, one, atol=1e-6, rtol=0)


def test_availability_mesh_must_be_a_mesh(avail_pair):
    _, tc = avail_pair
    with pytest.raises(TypeError, match="Mesh"):
        TK.availability_matrix_device(tc, [box(-3, 57, 0, 60)],
                                      ExclusionContainer(4326, res=0.01), mesh=object())
