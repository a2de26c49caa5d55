"""The port's device mesh (``atlite_tpu_torch/core/mesh.py``) and sharded
headline step against the JAX package's (tests/test_sharding.py,
tests/test_halo.py), on 8 CPU devices: the port's mesh repeats
``torch.device("cpu")``, JAX runs on the 8 virtual CPU devices of
tests/conftest.py.

Tolerances, from the arithmetic: the port sharded against the port
unsharded, gridded within 1e-6 * max (the serial regrid runs in float64,
the sharded one in float32), aggregated within 1e-5 * max in float32 (the
partial sums add in another order) and 1e-12 relative in float64; the
port against JAX within 1e-5 * max (JAX with x64 off, float32 as on its
chip, unless the mirrored JAX test runs under x64).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import __graft_entry__ as ge
from atlite_tpu.core import mesh as jmesh
from atlite_tpu_torch import aggregate
from atlite_tpu_torch.core import mesh as tmesh
from atlite_tpu_torch.core.mesh import (
    NamedSharding,
    P,
    ShardedTensor,
    field_spec,
    halo_exchange,
    make_mesh,
    map_shards,
    put_global,
    shard_fields,
    sharded_aggregate,
    sharded_aggregate_banded,
    sharded_regrid_bilinear,
)
from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.entry import dryrun_multichip, from_jax_inputs, sharded_step_fn, step_fn
from atlite_tpu_torch.gis.regrid import regrid

torch.set_num_threads(1)

CPU = torch.device("cpu")
GRID_TOL = 1e-6
AGG_TOL = 1e-5

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def cpu_mesh(n=8, t_axis=None):
    return make_mesh([CPU] * n, t_axis=t_axis)


def within(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = max(np.abs(want[ok]).max(), 1e-30) if ok.any() else 1.0
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=tol * scale)


# ---------------------------------------------------------------- the mesh
@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_make_mesh_factorization_equals_jax(n):
    got = cpu_mesh(n)
    want = jmesh.make_mesh(jax.devices()[:n])
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape


@pytest.mark.parametrize("n, t_axis", [(8, 1), (8, 2), (8, 8), (4, 4)])
def test_make_mesh_t_axis_equals_jax(n, t_axis):
    assert cpu_mesh(n, t_axis).shape == dict(jmesh.make_mesh(jax.devices()[:n], t_axis).shape)


def test_make_mesh_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()


def test_mesh_holds_one_device_type():
    with pytest.raises(ValueError, match="not both"):
        tmesh.Mesh([[CPU, torch.device("cuda", 0)]])
    with pytest.raises(ValueError, match="rectangular"):
        tmesh.Mesh([[CPU, CPU], [CPU]])


# ---------------------------------------------------------- shard_fields
def jax_blocks(arr, spec, mesh):
    """{(t, x): numpy block} of a JAX array placed on ``mesh``."""
    placed = jax.device_put(arr, JNamedSharding(mesh, spec))
    pos = {d: ij for ij, d in np.ndenumerate(mesh.devices)}
    return {pos[s.device]: np.asarray(s.data) for s in placed.addressable_shards}


def test_shard_fields_placement_equals_jax():
    mesh = cpu_mesh()
    jm = jmesh.make_mesh(jax.devices()[:8])
    T, Y, X = 4 * mesh.shape["t"], 8, 4 * mesh.shape["x"]
    rng = np.random.default_rng(0)
    fields = {"a": rng.random((T, Y, X), dtype=np.float32),
              "h": rng.random((Y, X), dtype=np.float32)}
    tables = {"t": rng.random(T, dtype=np.float32)}
    f, t = shard_fields(mesh, fields, tables)
    assert f["a"].spec == field_spec() and f["a"].parts == (4, 1, 2)
    assert f["h"].spec == (None, "x") and f["h"].parts == (1, 2)
    assert t["t"].spec == ("t",) and t["t"].parts == (4,)
    jf, jt = jmesh.shard_fields(jm, fields, tables)
    for got, want in ((f["a"], jf["a"]), (f["h"], jf["h"]), (t["t"], jt["t"])):
        blocks = jax_blocks(np.asarray(want), want.sharding.spec, jm)
        for ij in mesh.positions():
            np.testing.assert_array_equal(got[ij].numpy(), blocks[ij])
    for k, v in fields.items():
        np.testing.assert_array_equal(f[k].gather().numpy(), v)


@pytest.mark.parametrize("shape", [(6, 5, 7), (8, 5, 7), (6, 5, 8)])
def test_axes_that_do_not_divide_stay_whole(shape):
    mesh = cpu_mesh()  # (t=4, x=2)
    a = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    s = shard_fields(mesh, {"a": a})["a"]
    assert s.parts == (4 if shape[0] % 4 == 0 else 1, 1, 2 if shape[2] % 2 == 0 else 1)
    for ij in mesh.positions():
        i, j = ij
        ti = slice(None) if s.parts[0] == 1 else slice(i * shape[0] // 4, (i + 1) * shape[0] // 4)
        xj = slice(None) if s.parts[2] == 1 else slice(j * shape[2] // 2, (j + 1) * shape[2] // 2)
        np.testing.assert_array_equal(s[ij].numpy(), a[ti, :, xj])
    np.testing.assert_array_equal(s.gather().numpy(), a)
    assert len(s.distinct()) == s.parts[0] * s.parts[2]


def test_put_global_of_a_tensor_and_map_shards():
    mesh = cpu_mesh()
    a = torch.arange(8 * 3 * 4, dtype=torch.float64).reshape(8, 3, 4)
    s = put_global(a, NamedSharding(mesh, field_spec()))
    doubled = map_shards(lambda b: 2 * b, s)
    torch.testing.assert_close(doubled.gather(), 2 * a)
    summed = map_shards(lambda d: d["u"] + d["v"], {"u": s, "v": doubled})
    torch.testing.assert_close(summed.gather(), 3 * a)
    with pytest.raises(ValueError, match="cut alike"):
        map_shards(lambda b, c: b, s, put_global(a, NamedSharding(mesh, P(None, None, "x"))))


# ---------------------------------------------------------------- the halo
def test_halo_exchange_values():
    mesh = cpu_mesh(t_axis=1)  # 8-way x
    X = 32
    arr = np.arange(X, dtype=np.float32)[None, None, :].repeat(2, 0)
    s = put_global(arr, NamedSharding(mesh, P(None, None, "x")))
    ident = map_shards(lambda b: b[..., 2:-2], halo_exchange(s, 2, "x"))
    np.testing.assert_array_equal(ident.gather().numpy(), arr)
    left = map_shards(lambda b: b[..., :-2], halo_exchange(s, 1, "x"))
    expected = np.maximum(np.arange(X) - 1, 0)  # edge-replicated at x=0
    np.testing.assert_array_equal(left.gather().numpy()[0, 0], expected)


@pytest.mark.parametrize("halo", [1, 2, 3])
def test_halo_exchange_equals_jax_shard_map(halo):
    from jax import shard_map

    mesh, jm = cpu_mesh(t_axis=2), jmesh.make_mesh(jax.devices()[:8], t_axis=2)
    a = np.random.default_rng(halo).random((4, 3, 16)).astype(np.float32)

    @partial(shard_map, mesh=jm, in_specs=(JP("t", None, "x"),),
             out_specs=JP("t", None, "x"), check_vma=False)
    def f(block):
        return jmesh.halo_exchange(block, halo, "x")

    with jax.enable_x64(False):
        want = np.asarray(f(jnp.asarray(a)))
    got = halo_exchange(put_global(a, NamedSharding(mesh, field_spec())), halo).gather()
    np.testing.assert_array_equal(got.numpy(), want)


def test_halo_exchange_zero_is_noop():
    mesh = cpu_mesh(4, t_axis=1)
    a = np.arange(4 * 8, dtype=np.float32).reshape(4, 8)
    s = put_global(a, NamedSharding(mesh, P(None, "x")))
    assert halo_exchange(s, 0, "x") is s
    np.testing.assert_array_equal(halo_exchange(s, 0, "x").gather().numpy(), a)


def test_halo_exchange_needs_the_axis_cut():
    mesh = cpu_mesh(t_axis=1)
    s = put_global(np.zeros((2, 3, 12), np.float32), NamedSharding(mesh, field_spec()))
    with pytest.raises(ValueError, match="cut along"):
        halo_exchange(s, 1, "x")  # 12 columns do not divide 8


# ------------------------------------------------------- the sharded regrid
def regrid_case(dst_nx=16, dst_ny=7, seed=0):
    T, Y, X = 4, 12, 32
    data = np.random.default_rng(seed).random((T, Y, X)).astype(np.float32)
    src_x = np.arange(X, dtype=float) * 0.25 - 4 + 0.125
    src_y = np.arange(Y, dtype=float) * 0.25 + 50 + 0.125
    dst_x = np.linspace(src_x[0], src_x[-1], dst_nx)
    dst_y = np.linspace(src_y[0], src_y[-1], dst_ny)
    return data, src_x, src_y, dst_x, dst_y


@pytest.mark.parametrize("dst_nx, dst_ny", [(16, 7), (64, 23), (8, 12)])
def test_sharded_regrid_matches_serial(dst_nx, dst_ny):
    data, src_x, src_y, dst_x, dst_y = regrid_case(dst_nx, dst_ny)
    serial = regrid(DataArray(data.astype(float), coords={"time": np.arange(4), "y": src_y,
                                                          "x": src_x},
                              dims=("time", "y", "x")), dst_x, dst_y, resampling="bilinear")
    fn = sharded_regrid_bilinear(cpu_mesh(t_axis=2), src_x, src_y, dst_x, dst_y)
    out = fn(data)
    assert isinstance(out, ShardedTensor) and out.shape == (4, dst_ny, dst_nx)
    within(out.gather().numpy(), serial.values, GRID_TOL)


def test_sharded_regrid_equals_jax():
    data, src_x, src_y, dst_x, dst_y = regrid_case()
    jm = jmesh.make_mesh(jax.devices()[:8], t_axis=2)
    with jax.enable_x64(False):
        fn = jmesh.sharded_regrid_bilinear(jm, src_x, src_y, dst_x, dst_y)
        with jm:
            want = np.asarray(fn(jax.device_put(jnp.asarray(data),
                                                JNamedSharding(jm, JP("t", None, "x")))))
    got = sharded_regrid_bilinear(cpu_mesh(t_axis=2), src_x, src_y, dst_x, dst_y)(data)
    within(got.gather().numpy(), want, AGG_TOL)


@pytest.mark.parametrize("case, kw, match", [
    ("offset", dict(halo=1), "too small"),
    ("far", dict(), "exceeds the local shard width"),
], ids=["halo_too_small", "halo_exceeds_shard"])
def test_sharded_regrid_value_errors_equal_jax(case, kw, match):
    _, src_x, src_y, _, dst_y = regrid_case()
    if case == "offset":  # dst columns four cells right of their src
        dst_x = src_x[::2] + 1.0
    else:  # every dst column in the first shard's src range
        dst_x = np.linspace(src_x[0], src_x[3], 16)
    jm = jmesh.make_mesh(jax.devices()[:8], t_axis=2)
    with pytest.raises(ValueError, match=match) as want:
        jmesh.sharded_regrid_bilinear(jm, src_x, src_y, dst_x, dst_y, **kw)
    with pytest.raises(ValueError, match=match) as got:
        sharded_regrid_bilinear(cpu_mesh(t_axis=2), src_x, src_y, dst_x, dst_y, **kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- the aggregation
def region_rows(Y, X, B, rng, size=3):
    rows, cols, vals = [], [], []
    for b in range(B):
        y0, x0 = rng.integers(0, Y - size), rng.integers(0, X - size)
        cc = (np.arange(y0, y0 + size)[:, None] * X + np.arange(x0, x0 + size)[None, :]).ravel()
        rows += [b] * len(cc)
        cols += list(cc)
        vals += list(rng.random(len(cc)) + 0.1)
    return sp.csr_matrix((vals, (rows, cols)), shape=(B, Y * X))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_aggregate_banded_with_nan_cells(dtype):
    """JAX's test_sharded_aggregate_banded(_nan_semantics_and_dtype): a NaN
    cell poisons exactly the touching buses; the bands follow the field's
    dtype (float64 under x64, 1e-12 against the port's unsharded path)."""
    mesh = cpu_mesh()
    jm = jmesh.make_mesh(jax.devices()[:8])
    T, Y, X, B = 2 * mesh.shape["t"], 12, 8 * mesh.shape["x"], 13
    rng = np.random.default_rng(7)
    field = rng.random((T, Y, X)).astype(dtype)
    field[0, 3, 5] = np.nan
    field[1, 7, 2] = np.nan
    m = region_rows(Y, X, B, rng)
    got = sharded_aggregate_banded(mesh, m, Y, X, block_b=4, align=16)(field).gather().numpy()
    assert got.dtype == np.dtype(dtype) and got.shape == (T, B)
    unsharded = aggregate.spmm(m, torch.as_tensor(field).reshape(T, -1)).numpy()
    nan_cols = np.isnan(unsharded[0])
    assert nan_cols.any() and not nan_cols.all()
    within(got, unsharded, 1e-12 if dtype == "float64" else AGG_TOL)
    with jax.enable_x64(dtype == "float64"):
        agg = jmesh.sharded_aggregate_banded(jm, m, Y, X, block_b=4, align=16)
        with jm:
            want = np.asarray(agg(jax.device_put(field, JNamedSharding(jm, jmesh.field_spec()))))
    within(got, want, 1e-12 if dtype == "float64" else AGG_TOL)


def test_sharded_aggregate_banded_equals_jax_regions():
    mesh = cpu_mesh()
    jm = jmesh.make_mesh(jax.devices()[:8])
    T, Y, X, B = 4 * mesh.shape["t"], 16, 8 * mesh.shape["x"], 21
    rng = np.random.default_rng(1)
    field = rng.random((T, Y, X)).astype(np.float32)
    m = region_rows(Y, X, B - 1, rng)
    m = sp.vstack([m, sp.csr_matrix((1, Y * X))]).tocsr()  # an empty row
    got = sharded_aggregate_banded(mesh, m, Y, X, block_b=8, align=32)(field).gather().numpy()
    within(got, field.reshape(T, -1) @ m.toarray().T, AGG_TOL)
    with jax.enable_x64(False):
        agg = jmesh.sharded_aggregate_banded(jm, m, Y, X, block_b=8, align=32)
        with jm:
            want = np.asarray(agg(jax.device_put(field, JNamedSharding(jm, jmesh.field_spec()))))
    within(got, want, AGG_TOL)


def test_sharded_aggregate_banded_rejects_mismatched_columns():
    m = sp.random(5, 100, density=0.2, format="csr")
    with pytest.raises(ValueError, match="columns") as want:
        jmesh.sharded_aggregate_banded(jmesh.make_mesh(jax.devices()[:8]), m, 10, 8)
    with pytest.raises(ValueError, match="columns") as got:
        sharded_aggregate_banded(cpu_mesh(), m, 10, 8)  # 10*8 != 100
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("reshaped", [False, True], ids=["flat", "yx"])
def test_sharded_aggregate_dense_equals_jax(reshaped):
    """The dense sharded contraction, flat (B, Y*X) and co-cut (B, Y, X);
    as in JAX, a NaN cell spreads to every bus of its hour."""
    mesh = cpu_mesh()
    jm = jmesh.make_mesh(jax.devices()[:8])
    T, Y, X, B = 4 * mesh.shape["t"], 8, 4 * mesh.shape["x"], 5
    rng = np.random.default_rng(0)
    field = rng.random((T, Y, X)).astype(np.float32)
    field[2, 1, 3] = np.nan
    m = rng.random((B, Y * X)).astype(np.float32)
    shape = (Y, X) if reshaped else None
    got = sharded_aggregate(mesh, m, shape=shape)(field).gather().numpy()
    assert np.isnan(got[2]).all() and not np.isnan(np.delete(got, 2, axis=0)).any()
    clean = np.nan_to_num(field)
    within(np.delete(got, 2, axis=0), np.delete(clean.reshape(T, -1) @ m.T, 2, axis=0), AGG_TOL)
    with jax.enable_x64(False):
        agg = jmesh.sharded_aggregate(jm, m, shape=shape)
        with jm:
            want = np.asarray(agg(jax.device_put(field, JNamedSharding(jm, jmesh.field_spec()))))
    within(got, want, AGG_TOL)


# ----------------------------------------------------- the sharded step
def jax_step(args):
    with jax.enable_x64(False):
        return [np.asarray(a) for a in jax.jit(ge._step_fn())(*args)]


@pytest.mark.parametrize("n, nan", [(8, False), (8, True), (4, False), (2, True)],
                         ids=["8", "8_nan", "4", "2_nan"])
def test_sharded_step_matches_unsharded_and_jax(n, nan):
    """JAX's test_sharded_pipeline_matches_single_device: the step over the
    mesh, each block on its fields, latitudes and matrix columns, the
    partial series summed over "x"."""
    mesh = cpu_mesh(n)
    T, Y, X, B = 4 * mesh.shape["t"], 8, 8 * mesh.shape["x"], 3
    args = ge._example_inputs(T=T, Y=Y, X=X, B=B)
    if nan:
        args[0]["wnd100m"][1, 2, 3] = np.nan
        args[0]["wnd100m"][-1, 5, X - 1] = np.nan
    fields = {k: v for k, v in args[0].items()}
    wind, pv = sharded_step_fn(mesh)(shard_fields(mesh, fields), *args[1:])
    assert wind.spec == ("t", None) and wind.parts == (mesh.shape["t"], 1)
    got = [wind.gather().numpy(), pv.gather().numpy()]
    ref = [o.numpy() for o in step_fn()(*from_jax_inputs(*args, device="cpu"))]
    want = jax_step(args)
    for g, r, w in zip(got, ref, want):
        assert g.shape == (T, B)
        within(g, r, AGG_TOL)
        within(g, w, AGG_TOL)
    if nan:
        assert np.isnan(got[0]).any() and not np.isnan(got[0]).all()


def test_sharded_step_keeps_its_staging():
    mesh = cpu_mesh()
    args = ge._example_inputs(T=8, Y=4, X=8, B=2)
    step = sharded_step_fn(mesh)
    fields = shard_fields(mesh, args[0])
    a = step(fields, *args[1:])[0].gather()
    b = step(fields, *args[1:])[0].gather()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    lat2 = args[3] + 1.0  # another latitude array: staged again
    c = step(fields, args[1], args[2], lat2, *args[4:])[1].gather()
    want = step_fn()(*from_jax_inputs(args[0], args[1], args[2], lat2, *args[4:],
                                      device="cpu"))[1]
    within(c.numpy(), want.numpy(), AGG_TOL)


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_multichip(n):
    dryrun_multichip(n, devices=[CPU])


def test_dryrun_multichip_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dryrun_multichip(8)
