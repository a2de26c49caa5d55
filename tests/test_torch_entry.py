"""The port's headline step against ``jax.jit(__graft_entry__._step_fn())``
(x64 off, as the JAX package runs on its chip), and the port's
independence from JAX, the JAX package, pandas and PyYAML.

Tolerance: rtol 1e-5 / atol 2e-5 on both bus series, NaN masks equal.
The (24, 16, 32, 4) grid has a row at exactly 50 deg latitude, where the
latitude-optimal slope takes the float32 branch in both packages.
"""

import ast
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
BANNED = ("jax", "jaxlib", "atlite_tpu", "pandas", "yaml")


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
f = torch.rand(24, 575)
assert bsr_spmm.bsr_spmm_kernel(bsr_spmm.to_bsr(m), f).shape == (24, 3)
assert bsr_spmm.bsr_spmm_kernel.launches == 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print("PORT RUNS ALONE")
"""


def test_port_runs_without_jax_and_pandas():
    """Every module of the port imports, and the headline step, the
    Cutout's wind and PV (resident and streamed packed) and the BSR entry
    run, with jax, atlite_tpu, pandas and yaml refused."""
    out = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(banned=BANNED)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "PORT RUNS ALONE" in out.stdout


def imported_roots(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((ROOT / "atlite_tpu_torch").rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_banned_imports(path):
    assert not set(imported_roots(path)) & set(BANNED)


def test_chip_smoke_imports_only_the_port():
    allowed = {"__future__", "json", "re", "subprocess", "sys", "time", "numpy", "scipy", "torch",
               "atlite_tpu_torch"}
    assert set(imported_roots(ROOT / "chip_smoke.py")) <= allowed
