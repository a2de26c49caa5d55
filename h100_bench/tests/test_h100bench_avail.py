"""The ``avail`` entry (cell ``eur03-avail``) at a small size on the CPU:
found with no file edited, judged correct when sound, and not correct
with a fault planted in the program (the crop ignored, one dilation
fewer, one region's answer x 1.01, among up to 64 regions) or with the
reference in bfloat16."""

import copy

import numpy as np
import pytest
import torch

from h100_bench.harness import bench, check, named
from h100_bench.harness.session import Session

CELL = "eur03-avail"
SEED = 2**31 + 99


def small(config):
    """Four regions over a 0.6 x 0.5 deg box, edges of 9 vertices."""
    c = copy.deepcopy(config)
    c["regions"].update(bounds=[9.0, 50.0, 9.6, 50.5], ny=2, nx=2, edge_vertices=9)
    return c


@pytest.fixture
def cell(spec):
    c, config, traffic, e2e, layer = bench.resolve(CELL, spec)
    return c, small(config), traffic, e2e, layer


def run(cell, trace=0):
    return bench.run_cell(*cell, SEED, 0.5, trace, "cpu")


def test_entry_and_metrics_are_found(spec):
    c, config, traffic, e2e, layer = bench.resolve(CELL, spec)
    entry = named.module("entries", traffic["entry"])
    assert traffic["entry"] == "avail" and traffic["call_kwargs"] == {"backend": "device"}
    assert all(callable(getattr(entry, f)) for f in ("build", "reference", "answers", "limit"))
    assert {m["name"] for m in e2e} == {"setup_s", "device_peak_gb"}
    assert {m["name"] for m in layer} == {"avail_call_ms", "avail_shapes_ms", "avail_mask_ms",
                                          "idle_share.avail", "avail_roofline", "window_mpix"}
    assert all(m["workloads"] == [CELL] and m["moves"] == "setup_s" for m in layer)
    conf = next(x for x in spec["configs"] if x["name"] == c["config"])
    assert conf["reduced"] == ["countries"] and config["countries"] == ["DE"]
    assert [d["raster"] for d in config["excluder"]["layers"]] == ["natura", "corine", "corine"]


def test_sound_run_is_correct(cell):
    result, checks = run(cell)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s"}


def test_traced_run_reads_the_program(cell):
    """The program's spans and counter reach the per-layer metrics; the
    card's metrics need a card (none here)."""
    result, checks = run(cell, trace=1)
    assert result["correct"], checks
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["avail_shapes_ms"] > 0 and m["avail_mask_ms"] == 0
    assert m["window_mpix"] > 0 and m["avail_call_ms"] > 0


def crop_ignored(monkeypatch):
    from atlite_tpu_torch.gis import kernels

    monkeypatch.setattr(kernels, "_crop", lambda sel, inside, nodata: sel)


def one_dilation_fewer(monkeypatch):
    from atlite_tpu_torch.gis import kernels

    real = kernels._dilation_iterations
    monkeypatch.setattr(kernels, "_dilation_iterations", lambda b, r: real(b, r) - 1)


def one_region_altered(monkeypatch):
    from atlite_tpu_torch.gis import kernels

    real = kernels.availability_matrix_device

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0] *= 1.01
        return out
    monkeypatch.setattr(kernels, "availability_matrix_device", altered)


@pytest.mark.parametrize("fault", [crop_ignored, one_dilation_fewer, one_region_altered],
                         ids=["crop ignored", "one dilation fewer", "one region x 1.01"])
def test_planted_fault_is_not_correct(cell, monkeypatch, fault):
    fault(monkeypatch)
    result, checks = run(cell)
    assert not result["correct"], checks


@pytest.mark.parametrize("n", [2, 4, 8], ids=["4 regions", "16 regions", "64 regions"])
def test_one_region_fault_is_caught_among_many(cell, monkeypatch, n):
    """One region x 1.01 stays over the limit as the regions beside it
    dilute its share of the matrix's norm (the cell has 256: 0.01 / 16)."""
    c, config, traffic, e2e, layer = cell
    config = copy.deepcopy(config)
    config["regions"].update(ny=n, nx=n)
    one_region_altered(monkeypatch)
    result, checks = bench.run_cell(c, config, traffic, e2e, layer, SEED, 0.5, 0, "cpu")
    gap, limit = next((v, lim) for name, v, lim in checks if name == "rel_l2.avail")
    assert not result["correct"] and gap > 2 * limit, checks


def test_control_fails_the_limit(cell):
    _, config, traffic, _, _ = cell
    session = Session(config, traffic, 7, "cpu")
    gaps = check.control(session, torch.device("cpu"))
    assert gaps["avail"] > session.entry.limit(session, "avail"), gaps


def test_inputs_follow_the_seed(cell):
    """The same seed gives the same regions and rasters; another seed
    others, of the same sizes; the regions partition the box."""
    _, config, _, _, _ = cell
    entry = named.module("entries", "avail")
    a, b = entry.regions(config, 1), entry.regions(config, 2)
    np.testing.assert_array_equal(a, entry.regions(config, 1))
    assert a.shape == b.shape == (4, 32, 2) and not np.array_equal(a, b)
    c1, n1 = entry.rasters(config, 1, torch.device("cpu"))
    c2, _ = entry.rasters(config, 1, torch.device("cpu"))
    np.testing.assert_array_equal(c1, c2)
    assert c1.dtype == n1.dtype == np.uint8 and set(np.unique(n1)) <= {0, 1}
    # neighbours share their border's vertices: region 0's eastern edge is
    # region 1's western edge, walked the other way
    np.testing.assert_array_equal(a[0][9:16], a[1][24:32][::-1][:-1])
    # every region's box in degrees is its cell and the bend to each side
    r = config["regions"]
    x0, y0, x1, y1 = r["bounds"]
    dx, dy = (x1 - x0) / r["nx"], (y1 - y0) / r["ny"]
    for k, ring in enumerate(a):
        j, i = divmod(k, r["nx"])
        np.testing.assert_allclose(ring.min(axis=0), [x0 + i * dx - r["bend"] * dy,
                                                      y0 + j * dy - r["bend"] * dx], rtol=1e-12)
        np.testing.assert_allclose(ring.max(axis=0), [x0 + (i + 1) * dx + r["bend"] * dy,
                                                      y0 + (j + 1) * dy + r["bend"] * dx],
                                   rtol=1e-12)
