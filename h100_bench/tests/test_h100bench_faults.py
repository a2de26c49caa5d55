"""Runs driven through the whole harness at a small size on the CPU (the
program's plain path), with the look for a card skipped: sound, they come
out correct; with the timed path broken underneath, or with the control
(the reference in bfloat16) in the program's place, they do not."""

import importlib

import numpy as np
import pytest
import torch

from h100_bench.harness import bench, check
from h100_bench.harness.session import Session

CELLS = ["gb11-stream", "eur03-step", "gb11-resident"]


def run(small_cell, name, device="cpu"):
    cell, config, traffic, e2e, layer = small_cell(name)
    result, checks = bench.run_cell(cell, config, traffic, e2e, layer, 2**31 + 99, 0.3, 0, device)
    return result, checks


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, name):
    result, checks = run(small_cell, name)
    e2e = small_cell(name)[3]
    assert result["correct"], checks
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert {m["name"] for m in e2e if m["name"] != "device_peak_gb"} == set(result["metrics"])


def altered(values):
    return values * 1.01


def half_left_out(values):
    """The second half of the regions replaced by the mean over the rest."""
    out = values.clone() if isinstance(values, torch.Tensor) else np.array(values)
    b = out.shape[-1] if isinstance(values, torch.Tensor) else out.shape[0]
    if isinstance(values, torch.Tensor):  # (T, B)
        out[:, b // 2:] = out[:, :b // 2].mean(dim=1, keepdim=True)
    else:  # (B, T)
        out[b // 2:] = out[:b // 2].mean(axis=0)
    return out


def unchanged(state):
    """Returns the answer it gave before (the first one it lets through)."""
    def fault(values):
        if "last" in state:
            return state["last"]
        state["last"] = values
        return values
    return fault


FAULTS = {"answer altered": lambda: altered, "half of the regions left out": lambda: half_left_out,
          "state unchanged": lambda: unchanged({})}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(small_cell, monkeypatch, name, fault):
    convert = importlib.import_module("atlite_tpu_torch.convert")
    # the package's ``entry`` is a function; the module is the step's home
    entry = importlib.import_module("atlite_tpu_torch.entry")

    f = FAULTS[fault]()
    if name == "eur03-step":
        kernel = entry.wind_pv_bus_megakernel
        g = FAULTS[fault]()  # the PV series' own fault, so a stale PV repeats a PV answer

        def broken(*args, **kwargs):
            wind, pv = kernel(*args, **kwargs)
            return f(wind), g(pv)
        monkeypatch.setattr(entry, "wind_pv_bus_megakernel", broken)
    else:
        finish = convert.maybe_progressbar

        def broken(result, show_progress=False, **kwargs):
            result = finish(result, show_progress, **kwargs)
            return result.copy(f(result.values))
        monkeypatch.setattr(convert, "maybe_progressbar", broken)
    result, checks = run(small_cell, name)
    assert not result["correct"], checks


@pytest.mark.parametrize("name", ["eur03-step", "gb11-resident"])
def test_control_fails_a_number(small_cell, name):
    cell, config, traffic, _, _ = small_cell(name)
    session = Session(config, traffic, 7, "cpu")
    gaps = check.control(session, torch.device("cpu"))
    assert any(gap > session.entry.limit(session, label) for label, gap in gaps.items()), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_small_run_on_the_card(small_cell, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, checks = run(small_cell, name, device="cuda")
    assert result["correct"], checks
