"""The port's headline step against ``jax.jit(__graft_entry__._step_fn())``
(x64 off, as the JAX package runs on its chip), and the port's
independence from JAX, the JAX package, pandas, PyYAML, rasterio, h5py,
netCDF4 and xarray.

Tolerance: rtol 1e-5 / atol 2e-5 on both bus series, NaN masks equal.
The (24, 16, 32, 4) grid has a row at exactly 50 deg latitude, where the
latitude-optimal slope takes the float32 branch in both packages.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import bench
from atlite_tpu_torch import entry, from_jax_inputs, step_fn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "atlite_tpu", "pandas", "yaml", "rasterio", "h5py", "netCDF4",
          "xarray")


def jax_step(args):
    with jax.enable_x64(False):
        return [np.asarray(a) for a in jax.jit(ge._step_fn())(*args)]


def check(args_np):
    got = step_fn()(*from_jax_inputs(*args_np, device="cpu"))
    want = jax_step(args_np)
    for g, w in zip(got, want):
        g = g.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-5)


def test_entry_step_matches_jax_step():
    step, args = entry(device="cpu")
    args_np = ge._example_inputs()
    assert 50.0 in args_np[3]  # a row on the 50 deg breakpoint
    got = step(*args)
    want = jax_step(args_np)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (24, 4)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(48, 16, 24, 5), (30, 7, 13, 3)])
def test_step_matches_jax_step_at_bench_recipe(shape):
    check(bench.build_inputs(*shape))


def test_step_with_nan_cells():
    args_np = ge._example_inputs()
    args_np[0]["wnd100m"][3, 5, 7] = np.nan
    args_np[0]["roughness"][10, 2, 30] = np.nan
    check(args_np)


def test_x64_flips_the_50_degree_branch_of_the_reference():
    """Known reference behaviour (ROADMAP section 3): with x64 on, the JAX
    step compares the 50 deg row in float64 and takes the 40 deg slope,
    which moves the PV series far beyond the parity tolerance; hence the
    port is held against the JAX step with x64 off."""
    args_np = ge._example_inputs()
    f32_wind, f32_pv = jax_step(args_np)
    with jax.enable_x64(True):
        f64_wind, f64_pv = [np.asarray(a) for a in jax.jit(ge._step_fn())(*args_np)]
    np.testing.assert_allclose(f64_wind, f32_wind, rtol=1e-5, atol=2e-5)
    assert np.abs(f64_pv - f32_pv).max() > 1e-3


def test_step_builds_the_knot_table_once_per_curve(monkeypatch):
    """The step keeps the kernel's knot table of the curve it was last
    given: the same tensors reuse it; a curve written in place, or other
    tensors, build it again."""
    module = importlib.import_module("atlite_tpu_torch.entry")
    real, built = module.knot_table, []

    def counted(V, POWn):
        built.append(V)
        return real(V, POWn)

    monkeypatch.setattr(module, "knot_table", counted)
    step = step_fn()
    fields, eph, lon, lat, V, POWn, matrix = from_jax_inputs(*ge._example_inputs(T=4),
                                                             device="cpu")
    for _ in range(3):
        step(fields, eph, lon, lat, V, POWn, matrix)
    assert len(built) == 1
    POWn[5] = 0.5
    step(fields, eph, lon, lat, V, POWn, matrix)
    assert len(built) == 2
    step(fields, eph, lon, lat, V.clone(), POWn, matrix)
    assert len(built) == 3 and built[-1] is not V


def test_entry_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        from_jax_inputs(*ge._example_inputs(T=2, Y=2, X=2, B=1))


BLOCKER = """
import importlib.abc, sys
BANNED = {banned!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import importlib, pkgutil
import numpy as np, scipy.sparse as sp, torch
torch.set_num_threads(1)
import atlite_tpu_torch
for mod in pkgutil.walk_packages(atlite_tpu_torch.__path__, "atlite_tpu_torch."):
    importlib.import_module(mod.name)
from atlite_tpu_torch.ops import bsr_spmm, megakernel
step, args = atlite_tpu_torch.entry(device="cpu")
w, p = step(*args)
assert w.shape == (24, 4) and bool(torch.isfinite(p).all())
assert megakernel.wind_pv_bus_megakernel.launches == 0
c = atlite_tpu_torch.Cutout(device="cpu", module="synthetic", x=slice(-4, 1.5),
                            y=slice(56, 62), time="2013-01-01").prepare()
m = sp.random(3, 575, density=0.3, random_state=1, format="csr")
for kw in (dict(), dict(time_chunk=10, stream_pack="int16")):
    r = c.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None, **kw)
    q = c.pv(panel="CSi", orientation="latitude_optimal", matrix=m, aggregate_time=None, **kw)
    assert r.values.shape == q.values.shape == (3, 24) and np.isfinite(q.values).all()
h = c.heat_demand(matrix=m, aggregate_time=None, time_chunk=10, stream_pack="int16")
k = c.csp("SAM_solar_tower", matrix=m, aggregate_time=None)
i = c.irradiation(orientation="latitude_optimal", tracking="tilted_horizontal",
                  trigon_model="hay_davies", matrix=m, aggregate_time=None)
assert h.values.shape == (3, 1) and k.values.shape == i.values.shape == (3, 24)
f = torch.rand(24, 575)
assert bsr_spmm.bsr_spmm_kernel(bsr_spmm.to_bsr(m), f).shape == (24, 3)
assert bsr_spmm.bsr_spmm_kernel.launches == 0
from atlite_tpu_torch import native, resource
from atlite_tpu_torch.gis.geometry import LineString, box
assert native.get_lib() is not None
regions = {{"n": box(-4, 59, 1.5, 62), "s": box(-4, 56, 1.5, 59)}}
for kw in (dict(), dict(time_chunk=10)):
    r = c.wind("Vestas_V112_3MW", shapes=regions, per_unit=True, aggregate_time=None, **kw)
    assert r.values.shape == (2, 24) and np.isfinite(r.values).all()
q = c.pv("CSi", {{"slope": 30, "azimuth": 180}}, layout=c.uniform_density_layout(1.0, crs=3035),
         shapes=list(regions.values()), shapes_crs=4326, aggregate_time="sum")
assert q.values.shape == (2,)
s = c.wind(resource.WINDTURBINE_DIRECTORY / "eno_126_4", smooth=True, matrix=m,
           aggregate_time=None)
assert s.values.shape == (3, 24) and np.isfinite(s.values).all()
basins = {{"HYBAS_ID": [1, 2], "NEXT_DOWN": [0, 1], "DIST_MAIN": [10.0, 90.0],
          "geometry": [box(-4, 56, -1, 62), box(-1, 56, 1.5, 62)]}}
h = c.hydro({{"lon": [-2.0], "lat": [58.0]}}, basins, aggregate_time=None)
assert h.values.shape == (1, 24) and h.values.max() > 0
lr = c.line_rating([LineString([(-3.5, 57.0), (0.5, 60.0)])], line_resistance=1e-4)
assert lr.values.shape == (1, 24) and (lr.values > 0).all()
from atlite_tpu_torch import ExclusionContainer, regrid
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.gis.raster import Raster
landuse = Raster(np.random.default_rng(0).integers(0, 3, (160, 120)).astype(np.uint8),
                 Affine(5000.0, 0, 3.2e6, 0, -5000.0, 4.5e6), 3035, 255)
avail = []
for backend in ("device", "host"):
    exc = ExclusionContainer(3035, res=5000)
    exc.add_raster(landuse, codes=[1])
    avail.append(c.availabilitymatrix(regions, exc, backend=backend).values)
assert avail[0].shape == (2,) + c.shape and np.abs(avail[0] - avail[1]).max() < 0.1
g = c.grid_desc
field = atlite_tpu_torch.DataArray(torch.as_tensor(c.data["wnd100m"][:2]), dims=("time", "y", "x"),
                                   coords={{"time": g.time[:2], "y": g.y, "x": g.x}})
rg = regrid(field, np.arange(-3.5, 1.5, 0.5), np.arange(56.5, 62, 0.5), resampling="average")
assert rg.values.shape == (2, 11, 10) and np.isfinite(rg.values).all()
import tempfile
from pathlib import Path
path = Path(tempfile.mkdtemp()) / "store"
atlite_tpu_torch.Cutout(path, device="cpu", module="synthetic", x=slice(-4, 1.5),
                        y=slice(56, 62), time="2013-01-01").prepare(features=["wind"])
reopened = atlite_tpu_torch.Cutout(path, device="cpu")
r = reopened.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None, time_chunk=10)
assert np.array_equal(r.values, c.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None,
                                       time_chunk=10).values)
assert reopened.dt == "h" and len(reopened.grid) == 575 and reopened.prepared_features.rows()
assert (r.sel(time="2013-01-01 05:00") * 2).shape == (3,)
for table in (r, reopened.grid):
    try:
        table.to_pandas()
    except ImportError as exc:
        assert "refused: pandas" in str(exc)
    else:
        raise AssertionError("to_pandas ran without pandas")
from atlite_tpu_torch.core.mesh import make_mesh
atlite_tpu_torch.dryrun_multichip(8, devices=[torch.device("cpu")])
c.shard(make_mesh([torch.device("cpu")] * 4))
sh = c.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None).values
c.unshard()
assert np.abs(sh - c.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None).values).max() < 1e-3
from atlite_tpu_torch import data, utils
from atlite_tpu_torch.io import grib, netcdf
ncdir = Path(tempfile.mkdtemp())
c.to_netcdf(ncdir / "c.nc")
nc = atlite_tpu_torch.Cutout(ncdir / "c.nc", device="cpu")
assert np.array_equal(nc.data["wnd100m"], c.data["wnd100m"])
nc.to_file(ncdir / "c3.nc")
assert atlite_tpu_torch.Cutout(ncdir / "c3.nc", device="cpu").prepared
recs = grib.read("tests/data/era5_sample.grib")
assert grib.read(grib.encode_grib2(recs[:4]))[0]["shortName"] == recs[0]["shortName"]
e = atlite_tpu_torch.Cutout(ncdir / "e.nc", device="cpu", module="era5", x=slice(-4, 1.5),
                            y=slice(56, 62), time="2013-01-01",
                            era5_files="tests/data/era5_sample.grib").prepare()
assert e.prepared and e.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None).values.shape == (
    3, 24)
s = atlite_tpu_torch.Cutout(device="cpu", module="sarah", sarah_dir="tests/data/sarah",
                            x=slice(-4.9, -4.31), y=slice(56.1, 56.51), dx=0.1, dy=0.1,
                            time=slice("2013-05-01", "2013-05-01 23:00")).prepare()
assert np.isfinite(s.data["influx_direct"]).all()
assert netcdf.decode_cf_time([0.5], "hours since 1900-1-1 00:00:00")[0] == np.datetime64(
    "1900-01-01T00:30", "ns")
assert len(utils.timeindex_from_slice(slice("2013-01", "2013-02"))) == 1416
assert len(data.available_features("era5")) == 15
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print("PORT RUNS ALONE")
"""


def test_port_runs_without_jax_and_pandas():
    """Every module of the port imports, and the headline step, the
    Cutout's wind and PV (resident and streamed packed), heat demand
    (streamed packed), CSP from its YAML file, tracked Hay-Davies
    irradiation, the BSR entry, the C++ geometry engine, wind and PV by
    shapes (with a layout), a smoothed turbine read by its Path, hydro,
    line rating, the availability matrix (device path on the CPU and host
    path), ``regrid`` of a field held in a tensor, a store written by
    ``prepare``, reopened and streamed, ``dryrun_multichip`` and a sharded
    Cutout on CPU devices, a NetCDF cutout written and reopened, GRIB
    decoded and encoded, an ERA5 cutout prepared from GRIB into a ``.nc``
    file, a SARAH cutout from its archive, CF time, ``utils`` and
    ``data``, run with jax, atlite_tpu, pandas, yaml, rasterio, h5py,
    netCDF4 and xarray refused;
    ``to_pandas`` asks for pandas only when it is called."""
    out = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(banned=BANNED)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "PORT RUNS ALONE" in out.stdout


# a banned library that a function of this name may import when it is
# called (the export to the library's own objects)
LAZY = {"pandas": "to_pandas"}


def imported_roots(path):
    """The top-level modules a file imports, less the LAZY imports inside
    their functions."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    lazy = {(id(node), lib) for fn in ast.walk(tree)
            if isinstance(fn, ast.FunctionDef) and fn.name in LAZY.values()
            for node in ast.walk(fn) for lib in LAZY if LAZY[lib] == fn.name}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        yield from (r for r in roots if (id(node), r) not in lazy)


@pytest.mark.parametrize("path", sorted((ROOT / "atlite_tpu_torch").rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_banned_imports(path):
    assert not set(imported_roots(path)) & set(BANNED)


def test_chip_smoke_names_resolve():
    """Every global name a function of chip_smoke.py reads is defined in
    the module or a builtin: the card-only branches, which the CPU never
    runs, fail on no undefined helper."""
    import builtins
    import symtable

    table = symtable.symtable((ROOT / "chip_smoke.py").read_text(encoding="utf-8"),
                              "chip_smoke.py", "exec")
    defined = {s.get_name() for s in table.get_symbols() if s.is_assigned() or s.is_imported()
               or s.is_namespace()} | set(dir(builtins))
    missing, todo = set(), list(table.get_children())
    while todo:
        scope = todo.pop()
        todo += scope.get_children()
        missing |= {(scope.get_name(), s.get_name()) for s in scope.get_symbols()
                    if s.is_global() and s.is_referenced() and s.get_name() not in defined}
    assert not missing, sorted(missing)


def test_chip_smoke_imports_only_the_port():
    allowed = {"__future__", "ctypes", "dataclasses", "gc", "json", "logging", "mmap", "os",
               "pathlib", "re", "shutil", "subprocess", "sys", "tempfile", "threading", "time",
               "numpy", "scipy", "torch", "atlite_tpu_torch"}
    assert set(imported_roots(ROOT / "chip_smoke.py")) <= allowed
