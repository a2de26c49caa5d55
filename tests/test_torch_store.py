"""The port's ``.atc`` store against the JAX package's, on the CPU.

- A store written by either package reopens in the other with equal
  arrays, attrs, var_attrs and grid.
- From the same arrays both packages write byte-identical ``.npy`` files
  (equal sha256) and JSON-equal manifests, a variable with a space in its
  name included.
- The seven cases of ``tests/test_store.py`` run on the port: checksum,
  atomic rewrite, stale ``.old`` recovery, partial resume, each variable
  written once, untouched files kept, a crash before the manifest.
- ``wind`` and ``pv`` from a reopened store, resident and streamed raw and
  int16, equal the in-memory cutout's results exactly (the same float32
  bytes through the same code), and JAX's from its own reopened store
  within ``tests/test_torch_convert.py``'s tolerances: rtol 1e-5 / atol
  2e-5, int16 against int16 by the 99.9th percentile (1e-5 of the max)
  and the maximum (2e-2 of the max).
- A CPU cutout reopened from its read-only memory maps runs the
  converters on tensors of its own memory.
"""

import json
import os
import shutil
import warnings

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import atlite_tpu
import atlite_tpu.core.grid as jgrid
import atlite_tpu.core.store as jstore
import atlite_tpu_torch.core.store as store_mod
from atlite_tpu_torch import Cutout
from atlite_tpu_torch.core.grid import Grid
from atlite_tpu_torch.core.store import MANIFEST, read_store, update_store, var_path, write_store

torch.set_num_threads(1)

SMALL = dict(module="synthetic", x=slice(-2, 0), y=slice(50, 52), time="2013-01-01")
CONV = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 62),
            time=slice("2013-01-01", "2013-01-02"))
FEATURES = ["wind", "influx", "temperature", "height"]


def new(path=None, **kw):
    return Cutout(path, device="cpu", **{**SMALL, **kw})


def assert_same_store(got, want):
    """Two read_store results (grid_kwargs, data, attrs, var_attrs); the
    stamps compare as values (pandas may parse them at another unit)."""
    (gg, gd, ga, gv), (wg, wd, wa, wv) = got, want
    for k in ("x", "y"):
        assert gg[k].dtype == wg[k].dtype
        np.testing.assert_array_equal(gg[k], wg[k])
    np.testing.assert_array_equal(gg["time"].astype("datetime64[ns]"),
                                  wg["time"].astype("datetime64[ns]"))
    assert gg["crs"] == wg["crs"]
    assert set(gd) == set(wd)
    for k in wd:
        assert gd[k].dtype == wd[k].dtype and gd[k].shape == wd[k].shape
        np.testing.assert_array_equal(gd[k], wd[k])
    assert ga == wa and gv == wv


def test_jax_store_reopens_in_the_port(tmp_path):
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(tmp_path / "j", **SMALL).prepare()
    tc = Cutout(tmp_path / "j", device="cpu")
    assert tc.prepared and tc.name == "j"
    assert_same_store(read_store(tc.path), jstore.read_store(jc.path))
    np.testing.assert_array_equal(tc.grid_desc.time, jc.grid_desc.time)
    with jax.enable_x64(False):
        reopened = atlite_tpu.Cutout(tmp_path / "j")
    assert tc.attrs == reopened.attrs and tc.var_attrs == reopened.var_attrs
    for k in jc.data:
        np.testing.assert_array_equal(tc.data[k], jc.data[k])


def test_port_store_reopens_in_jax(tmp_path):
    tc = new(tmp_path / "t").prepare()
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(tmp_path / "t")
        assert jc.prepared
    assert_same_store(jstore.read_store(jc.path), read_store(tc.path))
    for k in tc.data:
        np.testing.assert_array_equal(jc.data[k], tc.data[k])
    # a JAX cutout's incremental update of the port's store keeps its files
    jc.data["wnd100m"] = np.asarray(jc.data["wnd100m"]) * 2
    jc.to_file(update_vars=["wnd100m"])
    np.testing.assert_array_equal(Cutout(tmp_path / "t", device="cpu").data["wnd100m"],
                                  np.asarray(tc.data["wnd100m"]) * 2)


def grids(x, y, time):
    return (jgrid.Grid(x=x, y=y, time=time, crs=4326), Grid(x=x, y=y, time=time, crs=4326))


def test_same_arrays_same_bytes(tmp_path):
    rng = np.random.default_rng(0)
    time = np.array(["2013-01-01T00", "2013-01-01T01", "2013-01-01T02:00:00.5",
                     "2013-01-01T03:00:00.000000007"], dtype="datetime64[ns]")
    jg, tg = grids(np.arange(3.0) * 0.25, 50 + np.arange(2.0) * 0.25, time)
    data = {"soil temperature": rng.random((4, 2, 3), dtype=np.float32),
            "wnd100m": rng.random((4, 2, 3)).astype(np.float32),
            "height": rng.random((2, 3))}
    attrs = {"module": "synthetic", "prepared_features": ["wind"], "dx": np.float64(0.25),
             "n": np.int64(3), "flag": np.bool_(True), "when": np.datetime64("2013-01-01T05"),
             "nested": {"a": np.arange(3), "b": (1, np.float32(2.5))}}
    var_attrs = {"soil temperature": {"dims": ("time", "y", "x"), "module": "synthetic",
                                      "feature": "temperature", "pack_min": 0.1},
                 "wnd100m": {"dims": ("time", "y", "x"), "module": "synthetic",
                             "feature": "wind"},
                 "height": {"dims": ("y", "x"), "module": "synthetic", "feature": "height"}}
    jstore.write_store(tmp_path / "j.atc", jg, data, attrs, var_attrs)
    write_store(tmp_path / "t.atc", tg, data, attrs, var_attrs)
    jm = json.loads((tmp_path / "j.atc" / MANIFEST).read_text())
    tm = json.loads((tmp_path / "t.atc" / MANIFEST).read_text())
    assert tm == jm
    assert (tmp_path / "t.atc" / MANIFEST).read_bytes() == (tmp_path / "j.atc" / MANIFEST).read_bytes()
    assert tm["coords"]["time"][2:] == ["2013-01-01 02:00:00.500000",
                                        "2013-01-01 03:00:00.000000007"]
    assert (tmp_path / "t.atc" / "soil__sp__temperature.npy").exists()
    for name in data:
        fn = var_path(tmp_path / "t.atc", tm, name)
        assert fn.read_bytes() == var_path(tmp_path / "j.atc", jm, name).read_bytes()
        assert store_mod._file_digest(fn) == jm["variables"][name]["sha256"]
    # and the versioned files of an incremental update
    data2 = {**data, "soil temperature": data["soil temperature"] + 1}
    jstore.update_store(tmp_path / "j.atc", jg, data2, attrs, var_attrs, ["soil temperature"])
    update_store(tmp_path / "t.atc", tg, data2, attrs, var_attrs, ["soil temperature"])
    assert sorted(os.listdir(tmp_path / "t.atc")) == sorted(os.listdir(tmp_path / "j.atc"))
    assert json.loads((tmp_path / "t.atc" / MANIFEST).read_text()) == \
        json.loads((tmp_path / "j.atc" / MANIFEST).read_text())
    assert_same_store(read_store(tmp_path / "j.atc"), jstore.read_store(tmp_path / "t.atc"))


def test_times_read_in_both_forms(tmp_path):
    """numpy's form of a stamp ("2013-01-01T00:00:00.000000000") reads back
    as pandas' does, and a reopened grid equals the stamps written, so an
    update does not fall back to a rewrite."""
    t = np.array(["2013-01-01T00", "2013-01-01T01"], dtype="datetime64[ns]")
    g = Grid(x=np.arange(3.0), y=np.arange(2.0), time=t)
    data = {"v": np.ones((2, 2, 3), np.float32)}
    write_store(tmp_path / "c.atc", g, data, {}, {})
    m = json.loads((tmp_path / "c.atc" / MANIFEST).read_text())
    m["coords"]["time"] = [str(s) for s in t]
    (tmp_path / "c.atc" / MANIFEST).write_text(json.dumps(m))
    gk, _, _, _ = read_store(tmp_path / "c.atc")
    np.testing.assert_array_equal(gk["time"], t)
    np.testing.assert_array_equal(jstore.read_store(tmp_path / "c.atc")[0]["time"], t)
    before = var_path(tmp_path / "c.atc", m, "v").stat().st_mtime_ns
    update_store(tmp_path / "c.atc", Grid(**gk), {**data, "w": data["v"]}, {}, {}, ["w"])
    assert var_path(tmp_path / "c.atc", m, "v").stat().st_mtime_ns == before


# ---- the seven cases of tests/test_store.py, on the port -----------------
def test_checksum_verification(tmp_path):
    c = new().prepare(features=["wind"])
    path = tmp_path / "c.atc"
    c.to_file(path)
    read_store(path, verify=True)
    target = next(path.glob("wnd100m.npy"))
    raw = bytearray(target.read_bytes())
    raw[-100] ^= 0xFF
    target.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        read_store(path, verify=True)


def test_atomic_rewrite_preserves_on_second_write(tmp_path):
    c = new(tmp_path / "c2")
    c.prepare(features=["wind"])
    c.prepare(features=["influx"])
    c2 = Cutout(tmp_path / "c2", device="cpu")
    assert "wnd100m" in c2.data and "influx_toa" in c2.data
    read_store(c2.path, verify=True)


def test_stale_old_backup_is_recovered(tmp_path):
    c = new(tmp_path / "c4")
    c.prepare(features=["wind"])
    path = c.path
    os.replace(path, str(path) + ".old")
    assert not path.exists()
    _, data, _, _ = read_store(path)  # recovers
    assert "wnd100m" in data and path.exists()
    shutil.copytree(path, str(path) + ".old")
    c2 = Cutout(path, device="cpu")
    c2.prepare(features=["influx"])  # a full rewrite beside a stale .old
    assert "influx_toa" in c2.data
    read_store(path, verify=True)


def test_partial_prepare_resume(tmp_path):
    new(tmp_path / "c3").prepare(features=["wind"])
    c2 = Cutout(tmp_path / "c3", device="cpu")
    assert not c2.prepared
    assert {f for _, f in c2.prepared_features.index} == {"wind"}
    c2.prepare()
    assert c2.prepared


def test_incremental_prepare_writes_each_variable_once(tmp_path, monkeypatch):
    writes = []
    real_save, real_replace = np.save, store_mod.os.replace

    def counting_save(f, arr, *a, **k):
        name = str(getattr(f, "name", f))
        if name.endswith(".npy"):
            writes.append(name.rsplit("/", 1)[-1])
        return real_save(f, arr, *a, **k)

    def counting_replace(src, dst):
        if str(dst).endswith(".npy"):
            writes.append(str(dst).rsplit("/", 1)[-1])
        return real_replace(src, dst)

    monkeypatch.setattr(store_mod.np, "save", counting_save)
    monkeypatch.setattr(store_mod.os, "replace", counting_replace)
    c = new(tmp_path / "inc")
    c.prepare()
    assert len(writes) == len(set(writes)), f"rewrites: {sorted(writes)}"
    assert len(writes) >= 10
    read_store(tmp_path / "inc.atc", verify=True)
    c2 = Cutout(tmp_path / "inc", device="cpu")
    assert c2.prepared
    np.testing.assert_array_equal(c2.data["wnd100m"], c.data["wnd100m"])


def test_incremental_update_preserves_untouched_files(tmp_path):
    c = new(tmp_path / "upd")
    c.prepare(features=["wind"])
    path = tmp_path / "upd.atc"
    wnd_fn = var_path(path, json.loads((path / MANIFEST).read_text()), "wnd100m")
    mtime_before = wnd_fn.stat().st_mtime_ns
    c.prepare(features=["influx"])
    manifest2 = json.loads((path / MANIFEST).read_text())
    assert var_path(path, manifest2, "wnd100m") == wnd_fn
    assert wnd_fn.stat().st_mtime_ns == mtime_before
    assert var_path(path, manifest2, "influx_toa").exists()
    read_store(path, verify=True)


def test_update_store_crash_before_manifest_is_consistent(tmp_path, monkeypatch):
    g = Grid(x=np.arange(3.0), y=np.arange(2.0),
             time=np.array(["2013-01-01", "2013-01-02"], dtype="datetime64[ns]"))
    path = tmp_path / "c.atc"
    old_arr = np.ones((2, 2, 3), np.float32)
    va = {"v": {"dims": ("time", "y", "x")}}
    write_store(path, g, {"v": old_arr}, {"module": "synthetic"}, va)
    real_replace = os.replace

    def exploding_replace(src, dst):
        if str(dst).endswith(MANIFEST):
            raise RuntimeError("simulated crash at the commit point")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", exploding_replace)
    with pytest.raises(RuntimeError, match="simulated crash"):
        update_store(path, g, {"v": old_arr * 7}, {"module": "synthetic"}, va, ["v"])
    monkeypatch.setattr(os, "replace", real_replace)
    _, data, _, _ = read_store(path, verify=True, mmap=False)
    np.testing.assert_array_equal(data["v"], old_arr)
    update_store(path, g, {"v": old_arr * 7}, {"module": "synthetic"}, va, ["v"])
    _, data2, _, _ = read_store(path, verify=True, mmap=False)
    np.testing.assert_array_equal(data2["v"], old_arr * 7)
    assert sorted(p.suffix for p in path.iterdir()) == [".json", ".npy"]


# ---- conversions from a reopened store --------------------------------------
MODES = {"resident": {}, "streamed raw": dict(time_chunk=20),
         "streamed int16": dict(time_chunk=20, stream_pack="int16")}


def convert(c, name, m, kw):
    if name == "wind":
        return c.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None, **kw)
    return c.pv("CSi", "latitude_optimal", matrix=m, aggregate_time=None, **kw)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("stores")
    tc = Cutout(root / "t", device="cpu", **CONV).prepare(features=FEATURES)
    with jax.enable_x64(False):
        atlite_tpu.Cutout(root / "j", **CONV).prepare(features=FEATURES)
        jc = atlite_tpu.Cutout(root / "j")
    C = tc.shape[0] * tc.shape[1]
    m = sp.random(5, C, density=0.3, random_state=2, format="csr", dtype=np.float32)
    return tc, Cutout(root / "t", device="cpu"), jc, m


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["wind", "pv"])
def test_reopened_equals_in_memory_bit_for_bit(stores, name, mode):
    tc, reopened, _, m = stores
    assert isinstance(reopened.data["wnd100m"], np.memmap)
    got = convert(reopened, name, m, MODES[mode])
    want = convert(tc, name, m, MODES[mode])
    assert got.values.shape == (5, 48)
    assert got.values.tobytes() == want.values.tobytes()


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["wind", "pv"])
def test_reopened_against_jax_reopened(stores, name, mode):
    _, reopened, jc, m = stores
    got = convert(reopened, name, m, MODES[mode])
    with jax.enable_x64(False):
        want = np.asarray(convert(jc, name, m, MODES[mode]).values)
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(want))
    if mode == "streamed int16":
        diff, scale = np.abs(got.values - want), np.abs(want).max()
        assert np.quantile(diff, 0.999) <= 1e-5 * scale
        assert diff.max() <= 2e-2 * scale
    else:
        np.testing.assert_allclose(got.values, want, rtol=1e-5, atol=2e-5)


def test_readonly_mmap_on_the_cpu(stores):
    """The CPU tensors of a reopened cutout own their memory: no warning
    about a read-only array, an in-place op neither faults nor reaches the
    store, and the converters run on them."""
    tc, _, _, m = stores
    c = Cutout(tc.path, device="cpu")
    assert not c.data["wnd100m"].flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fields = c.fields()
        fields["wnd100m"].mul_(0.0)
        assert float(np.abs(c.data["wnd100m"]).max()) > 0
        assert float(np.abs(read_store(tc.path)[1]["wnd100m"]).max()) > 0
        c._invalidate()
        got = convert(c, "wind", m, {})
    np.testing.assert_array_equal(got.values, convert(tc, "wind", m, {}).values)
