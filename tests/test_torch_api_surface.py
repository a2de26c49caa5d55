"""The port's public surface against the JAX package's: every public
function of ``atlite_tpu.convert``, of the GIS modules (``gis.exclusion``,
``gis.raster``, ``gis.regrid``, ``gis.kernels``, ``gis.geotiff``, their
classes' methods included), of ``core.mesh`` and ``core.comm``, of every
``io`` module, every dataset module, ``data`` and ``utils``, and
``__graft_entry__.dryrun_multichip`` has its counterpart with the same
signature (port-only parameters listed); the top-level ``__all__`` and the
``gis`` namespace cover the JAX ones; and the public members of
``Cutout`` and ``DataArray`` are the JAX ones less an explicit list of
names deferred to later slices (now none).

Also the five keyword arguments of ``convert_and_aggregate`` that the
port once dropped (``shapes_crs``, ``capacity_factor``,
``capacity_factor_timeseries``, ``show_progress``, ``dask_kwargs``): each
is accepted with the JAX semantics, and the deprecated two give the JAX
result with its ``FutureWarning``.  Tolerance: rtol 1e-5, atol 2e-5
(float32 chains, JAX with x64 off), as in ``test_torch_convert.py``.
"""

import importlib
import inspect
import warnings

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import atlite_tpu
import atlite_tpu.convert as jconvert
from atlite_tpu.dataarray import DataArray as JDataArray
from atlite_tpu.gis.geometry import box as jbox
import atlite_tpu_torch
import atlite_tpu_torch.convert as tconvert
from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.gis.geometry import box

torch.set_num_threads(1)

# parameters only the port has: where its functions run
PORT_ONLY = {"convert_line_rating": {"device"}, "compute_availabilitymatrix": {"mesh"},
             "global_mesh": {"devices"}, "dryrun_multichip": {"devices"},
             "migrate_from_cutout_directory": {"device"}}
# members of the JAX classes that later slices port (ROADMAP queue 1)
DEFERRED_CUTOUT = set()
DEFERRED_DATAARRAY = set()
# the port's own: its torch dtype, the counters of what fields() staged, of
# what the streamer staged, packed and waited for, and of the cell-hours the
# degree-day converters folded into days
PORT_ONLY_MEMBERS = {"Cutout": {"torch_dtype", "staged_variables", "staged_bytes",
                                "streamed_bytes", "stream_pack_s", "stream_wait_s",
                                "packed_native", "daily_cell_hours"},
                     "DataArray": set()}


def public_functions(module):
    return {n: f for n, f in vars(module).items()
            if inspect.isfunction(f) and not n.startswith("_") and f.__module__ == module.__name__}


JAX_FUNCTIONS = public_functions(jconvert)


def test_convert_has_every_public_function():
    assert set(public_functions(tconvert)) == set(JAX_FUNCTIONS)


def same_signature(got, want, name):
    """``got`` has ``want``'s parameters (name, kind, default) in order,
    besides the port-only ones of ``name``, which it must have."""
    got, want = inspect.signature(got), inspect.signature(want)
    extra = PORT_ONLY.get(name, set())
    kept = [p for p in got.parameters.values() if p.name not in extra]
    assert [(p.name, p.kind, p.default) for p in kept] == \
        [(p.name, p.kind, p.default) for p in want.parameters.values()]
    assert extra <= set(got.parameters)


@pytest.mark.parametrize("name", sorted(JAX_FUNCTIONS))
def test_convert_signature(name):
    same_signature(getattr(tconvert, name), JAX_FUNCTIONS[name], name)


GIS_MODULES = ["exclusion", "raster", "regrid", "kernels", "geotiff"]


def public_callables(module):
    """Public functions (jit-wrapped ones included) and the public methods
    of the public classes defined in ``module``, by name."""
    out = {}
    for n, f in vars(module).items():
        if n.startswith("_") or getattr(f, "__module__", None) != module.__name__:
            continue
        if inspect.isclass(f):
            for m, g in vars(f).items():
                g = g.__func__ if isinstance(g, (staticmethod, classmethod)) else g
                if not m.startswith("_") and inspect.isfunction(g) or m == "__init__":
                    out[f"{n}.{m}"] = g
        elif callable(f):
            out[n] = f
    return out


GIS_CALLABLES = [(mod, name) for mod in GIS_MODULES for name in sorted(public_callables(
    importlib.import_module(f"atlite_tpu.gis.{mod}")))]


@pytest.mark.parametrize("mod", GIS_MODULES)
def test_gis_module_has_every_public_callable(mod):
    want = public_callables(importlib.import_module(f"atlite_tpu.gis.{mod}"))
    got = public_callables(importlib.import_module(f"atlite_tpu_torch.gis.{mod}"))
    assert set(want) <= set(got)


@pytest.mark.parametrize("mod, name", GIS_CALLABLES, ids=[f"{m}.{n}" for m, n in GIS_CALLABLES])
def test_gis_signature(mod, name):
    want = public_callables(importlib.import_module(f"atlite_tpu.gis.{mod}"))[name]
    got = public_callables(importlib.import_module(f"atlite_tpu_torch.gis.{mod}"))[name]
    same_signature(got, want, name)


CORE_MODULES = ["mesh", "comm"]
CORE_FUNCTIONS = [(mod, name) for mod in CORE_MODULES for name in sorted(public_functions(
    importlib.import_module(f"atlite_tpu.core.{mod}")))]


@pytest.mark.parametrize("mod", CORE_MODULES)
def test_core_module_has_every_public_function(mod):
    want = public_functions(importlib.import_module(f"atlite_tpu.core.{mod}"))
    got = public_functions(importlib.import_module(f"atlite_tpu_torch.core.{mod}"))
    assert set(want) <= set(got)


@pytest.mark.parametrize("mod, name", CORE_FUNCTIONS,
                         ids=[f"{m}.{n}" for m, n in CORE_FUNCTIONS])
def test_core_signature(mod, name):
    want = public_functions(importlib.import_module(f"atlite_tpu.core.{mod}"))[name]
    got = public_functions(importlib.import_module(f"atlite_tpu_torch.core.{mod}"))[name]
    same_signature(got, want, name)


IO_MODULES = ["io.netcdf3", "io.netcdf", "io.hdf5", "io.hdf5_write", "io.grib", "io.png",
              "io.jp2", "io.aec", "io.zstd", "io.szip", "io.cds", "datasets.era5",
              "datasets.sarah", "datasets.gebco", "datasets.ncep", "datasets.cordex", "data",
              "utils"]
IO_CALLABLES = [(mod, name) for mod in IO_MODULES for name in sorted(public_callables(
    importlib.import_module(f"atlite_tpu.{mod}")))]


@pytest.mark.parametrize("mod", IO_MODULES)
def test_io_module_has_every_public_callable(mod):
    want = importlib.import_module(f"atlite_tpu.{mod}")
    got = importlib.import_module(f"atlite_tpu_torch.{mod}")
    assert set(public_callables(want)) <= set(public_callables(got))
    # the module-level constants of the dataset contract and the tables
    for name in ("crs", "features", "static_features", "dx", "dy", "dt", "GRIB1_PARAMS",
                 "GRIB2_PARAMS", "CDS_NAMES", "FEATURE_SHORTNAMES", "PRODUCT", "G0"):
        if hasattr(want, name):
            assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("mod, name", IO_CALLABLES, ids=[f"{m}.{n}" for m, n in IO_CALLABLES])
def test_io_signature(mod, name):
    want = public_callables(importlib.import_module(f"atlite_tpu.{mod}"))[name]
    got = public_callables(importlib.import_module(f"atlite_tpu_torch.{mod}"))[name]
    same_signature(got, want, name)


def test_dataset_registry():
    from atlite_tpu.datasets import modules as jmodules
    from atlite_tpu_torch.datasets import modules

    assert list(modules) == list(jmodules)
    for name, mod in jmodules.items():
        assert modules[name].__name__ == mod.__name__.replace("atlite_tpu.", "atlite_tpu_torch.")


def test_dryrun_multichip_signature():
    import __graft_entry__ as ge
    import atlite_tpu_torch.entry  # noqa: F401  (the module; the package exports entry())
    import sys

    same_signature(sys.modules["atlite_tpu_torch.entry"].dryrun_multichip, ge.dryrun_multichip,
                   "dryrun_multichip")


def test_top_level_and_gis_namespaces_cover_jax():
    import atlite_tpu.gis as jgis
    import atlite_tpu_torch.gis as tgis

    assert set(atlite_tpu.__all__) <= set(atlite_tpu_torch.__all__)
    for name in atlite_tpu.__all__:
        assert hasattr(atlite_tpu_torch, name), name
    assert set(jgis.__all__) <= set(tgis.__all__)
    for name in [n for n in vars(jgis) if not n.startswith("_") and callable(getattr(jgis, n))]:
        assert callable(getattr(tgis, name, None)), name
    assert atlite_tpu_torch.windturbines.Vestas_V112_3MW.name == "Vestas_V112_3MW.yaml"


def public_members(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


@pytest.mark.parametrize("jax_cls, port_cls, deferred", [
    (atlite_tpu.Cutout, atlite_tpu_torch.Cutout, DEFERRED_CUTOUT),
    (JDataArray, DataArray, DEFERRED_DATAARRAY),
], ids=["Cutout", "DataArray"])
def test_class_members(jax_cls, port_cls, deferred):
    want, got = public_members(jax_cls), public_members(port_cls)
    # the deferred list names exactly what is missing: a member ported
    # leaves it, and nothing else may be missing
    assert want - got == deferred
    assert got - want == PORT_ONLY_MEMBERS[port_cls.__name__]


SMALL = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 62), time="2013-01-01")


@pytest.fixture(scope="module")
def pair():
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **SMALL).prepare(features=["wind"])
    tc = atlite_tpu_torch.Cutout(device="cpu", **SMALL).prepare(features=["wind"])
    C = tc.shape[0] * tc.shape[1]
    m = sp.random(3, C, density=0.3, random_state=1, format="csr", dtype=np.float32)
    return jc, tc, m


def wind(c, **kw):
    return c.wind("Vestas_V112_3MW", **kw)


def close(got, want):
    assert got.dims == want.dims
    np.testing.assert_allclose(got.values, np.asarray(want.values), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("kw", [dict(show_progress=False), dict(show_progress=True),
                                dict(dask_kwargs={}), dict(dask_kwargs={"scheduler": "threads"})],
                         ids=["show_progress_false", "show_progress_true", "dask_kwargs_empty",
                              "dask_kwargs_scheduler"])
def test_accepted_and_ignored(pair, kw):
    jc, tc, m = pair
    with jax.enable_x64(False):
        want = wind(jc, matrix=m, aggregate_time="sum", **kw)
    got = wind(tc, matrix=m, aggregate_time="sum", **kw)
    assert got.values.shape == (3,)
    close(got, want)
    # and without aggregation in space
    got = wind(tc, aggregate_time="mean", **kw)
    with jax.enable_x64(False):
        close(got, wind(jc, aggregate_time="mean", **kw))


@pytest.mark.parametrize("shapes_crs", [4326, "EPSG:4326", 3035])
def test_shapes_crs(pair, shapes_crs):
    from atlite_tpu.gis.crs import transform_points

    jc, tc, _ = pair
    x0, y0, x1, y1 = -3.3, 56.6, 0.9, 60.1
    if shapes_crs == 3035:
        (x0, x1), (y0, y1) = transform_points(np.array([x0, x1]), np.array([y0, y1]), 4326, 3035)
    with jax.enable_x64(False):
        want = wind(jc, shapes=[jbox(x0, y0, x1, y1)], shapes_crs=shapes_crs,
                    aggregate_time=None)
    got = wind(tc, shapes=[box(x0, y0, x1, y1)], shapes_crs=shapes_crs, aggregate_time=None)
    assert got.values.shape == (1, 24)
    close(got, want)


@pytest.mark.parametrize("flag, agg", [("capacity_factor", "mean"),
                                       ("capacity_factor_timeseries", None)])
def test_deprecated_capacity_factor(pair, flag, agg):
    jc, tc, m = pair
    with jax.enable_x64(False), pytest.warns(FutureWarning, match=flag):
        want = wind(jc, matrix=m, **{flag: True})
    with pytest.warns(FutureWarning, match=flag):
        got = wind(tc, matrix=m, **{flag: True})
    close(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        close(got, wind(tc, matrix=m, aggregate_time=agg))
    for c in (jc, tc):
        with pytest.raises(ValueError, match="Cannot use 'aggregate_time'"):
            wind(c, matrix=m, aggregate_time="sum", **{flag: True})
