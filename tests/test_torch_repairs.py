"""Faults found in the port and repaired (ROADMAP §3), each held here.

- int16 streaming of data outside its stored pack range raises instead of
  clipping (JAX clips silently; its resident result is the reference);
- the store's sweep of orphaned temporary directories matches its own
  name literally, not as a glob pattern;
- the cold availability mask puts each row block in its own rows of the
  one cached mask, which a warm call returns as it is;
- the streamer counts its copies to the card (none on the CPU);
- a Cutout's text names its prepared features as the JAX package's does.

Tolerance of the resident parity: rtol 1e-5, atol 2e-5 (float32 chains,
JAX with x64 off), as in ``test_torch_convert.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax

import atlite_tpu
import atlite_tpu_torch
from atlite_tpu_torch import ExclusionContainer
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.gis import kernels
from atlite_tpu_torch.gis.geometry import box
from atlite_tpu_torch.gis.raster import Raster

torch.set_num_threads(1)

SMALL = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 62),
             time=slice("2013-01-01", "2013-01-03"))


def test_int16_streaming_refuses_data_outside_its_pack_range():
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **SMALL).prepare(features=["temperature"])
        jc.data["temperature"] = jc.data["temperature"] + 30
        jc._invalidate()
        want = np.asarray(jc.temperature(aggregate_time=None).values)
    tc = atlite_tpu_torch.Cutout(device="cpu", **SMALL).prepare(features=["temperature"])
    tc.data["temperature"] = tc.data["temperature"] + 30
    tc._invalidate()
    got = tc.temperature(aggregate_time=None).values
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    assert got.max() > 30
    with pytest.raises(ValueError, match="'temperature'.*outside its int16 pack range"):
        tc.temperature(aggregate_time=None, time_chunk=20, stream_pack="int16")
    # raw streaming is unaffected
    raw = tc.temperature(aggregate_time=None, time_chunk=20).values
    np.testing.assert_allclose(raw, got, rtol=1e-6, atol=1e-6)


def test_int16_streaming_accepts_data_within_half_a_step_of_its_range():
    tc = atlite_tpu_torch.Cutout(device="cpu", **SMALL).prepare(features=["temperature"])
    off, scale, _ = tc.pack_params(["temperature"])["temperature"]
    # the top of the range moved up by 0.4 of a step: still code 65534
    tc.data["temperature"] = tc.data["temperature"].copy()
    top = np.unravel_index(np.nanargmax(tc.data["temperature"]), tc.data["temperature"].shape)
    tc.data["temperature"][top] += 0.4 * scale
    out = tc.temperature(aggregate_time=None, time_chunk=20, stream_pack="int16").values
    assert np.isfinite(out).all()
    tc.data["temperature"][top] += 0.2 * scale
    with pytest.raises(ValueError, match="pack range"):
        tc.temperature(aggregate_time=None, time_chunk=20, stream_pack="int16")


def test_store_sweeps_only_its_own_orphans(tmp_path):
    kw = dict(device="cpu", module="synthetic", x=slice(-4, -3), y=slice(56, 57),
              time="2013-01-01")
    other = tmp_path / "ab.atc.tmp_in_progress"   # another store's write
    orphan = tmp_path / "a[bc].atc.tmp_orphan"    # this store's crashed write
    other.mkdir()
    orphan.mkdir()
    atlite_tpu_torch.Cutout(tmp_path / "a[bc]", **kw).prepare(features=["height"])
    assert other.is_dir()
    assert not orphan.exists()
    assert atlite_tpu_torch.Cutout(tmp_path / "a[bc]", device="cpu").prepared_features.rows()


def test_cold_mask_blocks_land_in_their_rows_and_a_warm_call_reuses_the_mask(monkeypatch):
    """A cold host mask built over several row blocks equals the one-block
    build row for row (no block lands in another's rows), and a warm call
    returns the cached tensor itself, building and allocating nothing."""
    from atlite_tpu_torch.gis import exclusion

    c = atlite_tpu_torch.Cutout(device="cpu", module="synthetic", x=slice(-4, 1.5),
                                y=slice(56, 62), time="2013-01-01").prepare(features=["height"])
    rng = np.random.default_rng(0)
    # int32: a layer the device does not sample, so the host builds the mask
    landuse = Raster(rng.integers(1, 6, (640, 580)).astype(np.int32),
                     Affine(0.01, 0, -4.2, 0, -0.01, 62.2), 4326, 255)
    regions = [box(-4, 56, -1.25, 62), box(-1.25, 56, 1.5, 62)]

    def excluder():
        exc = ExclusionContainer(crs=4326, res=0.01)
        exc.add_raster(landuse, codes=[4, 5])
        return exc

    real_build, builds = exclusion.build_exclusion_mask, []

    def counted(*args, **kwargs):
        builds.append(args[2])
        return real_build(*args, **kwargs)

    monkeypatch.setattr(exclusion, "build_exclusion_mask", counted)
    one = excluder()
    want = kernels.availability_matrix_device(c, regions, one)
    assert len(builds) == 1
    exc = excluder()
    # small device blocks: several row blocks a call
    cold = kernels.availability_matrix_device(c, regions, exc, max_device_pixels=200_000)
    assert len(builds) > 3
    mask = exc._fine_mask_cache[1]
    assert mask.shape == one._fine_mask_cache[1].shape == builds[0]
    assert torch.equal(mask, one._fine_mask_cache[1])

    real_shared, returned = kernels._shared_mask, []

    def shared(*args):
        returned.append(real_shared(*args))
        return returned[-1]

    monkeypatch.setattr(kernels, "_shared_mask", shared)
    n = len(builds)
    warm = kernels.availability_matrix_device(c, regions, exc, max_device_pixels=200_000)
    assert len(builds) == n
    assert returned[0] is mask and returned[0].data_ptr() == mask.data_ptr()
    np.testing.assert_array_equal(cold, want)
    np.testing.assert_array_equal(warm, want)


def test_cold_mask_selects_the_native_codes_once(monkeypatch):
    """A cold call over several row blocks selects a host layer's codes on
    its native raster once: every block's build reads the same native
    mask."""
    from atlite_tpu_torch.gis import exclusion

    c = atlite_tpu_torch.Cutout(device="cpu", module="synthetic", x=slice(-4, 1.5),
                                y=slice(56, 62), time="2013-01-01")
    data = np.random.default_rng(1).integers(1, 6, (640, 580)).astype(np.int32)
    exc = ExclusionContainer(crs=4326, res=0.01)
    exc.add_raster(Raster(data, Affine(0.01, 0, -4.2, 0, -0.01, 62.2), 4326, 255), codes=[4, 5])
    real, native = exclusion._code_select, []

    def counted(values, codes):
        native.append(np.shape(values) == data.shape)
        return real(values, codes)

    real_build, builds = exclusion.build_exclusion_mask, []

    def built(*args, **kwargs):
        builds.append(args[2])
        return real_build(*args, **kwargs)

    monkeypatch.setattr(exclusion, "_code_select", counted)
    monkeypatch.setattr(exclusion, "build_exclusion_mask", built)
    kernels.availability_matrix_device(c, [box(-4, 56, 1.5, 62)], exc, max_device_pixels=200_000)
    assert len(builds) > 2 and sum(native) == 1


def test_streamer_counts_no_copy_on_the_cpu():
    c = atlite_tpu_torch.Cutout(device="cpu", **SMALL).prepare(features=["wind"])
    m = sp.random(3, c.shape[0] * c.shape[1], density=0.3, random_state=1, format="csr")
    before = atlite_tpu_torch.Cutout._stream_copies
    r = c.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None, time_chunk=24)
    assert r.values.shape == (3, 72)
    assert atlite_tpu_torch.Cutout._stream_copies == before


def test_repr_equals_jax_for_a_cutout_of_two_modules(tmp_path):
    kw = dict(module=["sarah", "synthetic"], sarah_dir="tests/data/sarah", x=slice(-4.95, -4.21),
              y=slice(56.05, 56.61), time=slice("2013-05-01", "2013-05-01 23:00"), dx=0.05,
              dy=0.05)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    with jax.enable_x64(False):
        want = repr(atlite_tpu.Cutout(tmp_path / "jax" / "sarah", **kw).prepare(
            features=["influx", "temperature"]))
    got = repr(atlite_tpu_torch.Cutout(tmp_path / "port" / "sarah", device="cpu", **kw).prepare(
        features=["influx", "temperature"]))
    assert got == want
    assert "'temperature'" in got
