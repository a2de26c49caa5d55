"""The stored JAX step (``tests/data_torch/jax_step_bench.npz``, written by
``tools/make_jax_step_reference.py``) is still what the JAX package
computes: the bench-shape inputs are built again, and the step of their
first 24 hours (each hour's outputs depend on that hour alone) is run
through JAX on the CPU with x64 off and held against the stored rows.
Tolerance: rtol 1e-5, atol 2e-5 (XLA compiles the shorter run apart).
The port's step equals JAX's on the bench recipe in
``tests/test_torch_entry.py``; ``chip_smoke.py`` holds the card's step
against this file."""

from pathlib import Path

import jax
import numpy as np

import bench
import __graft_entry__ as ge

ROOT = Path(__file__).resolve().parents[1]
STORED = ROOT / "tests" / "data_torch" / "jax_step_bench.npz"
HOURS = 24


def test_stored_jax_step_is_current():
    ref = np.load(STORED)
    T, Y, X, B = (int(v) for v in ref["shape"])
    assert (T, Y, X, B) == (2184, 96, 128, 20) and int(ref["seed"]) == 3
    for name in ("wind_bus", "pv_bus"):
        assert ref[name].shape == (T, B) and ref[name].dtype == np.float32
        assert np.isfinite(ref[name]).all()
    fields, eph, lon, lat, V, POWn, matrix = bench.build_inputs(T, Y, X, B, seed=3)
    fields = {k: np.ascontiguousarray(v[:HOURS]) if v.ndim == 3 else v for k, v in fields.items()}
    eph = {k: v[:HOURS] for k, v in eph.items()}
    with jax.enable_x64(False):
        got = jax.jit(ge._step_fn())(fields, eph, lon, lat, V, POWn, matrix)
    for name, g in zip(("wind_bus", "pv_bus"), got):
        np.testing.assert_allclose(np.asarray(g), ref[name][:HOURS], rtol=1e-5, atol=2e-5)
