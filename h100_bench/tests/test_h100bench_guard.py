"""The import guard, and runs that must fail without printing a result."""

import shutil
import subprocess
import sys

from h100_bench.harness.bench import BENCH, CHECKOUT
from h100_bench.harness.guard import forbidden_modules


def test_guard_compares_whole_top_level_names():
    assert forbidden_modules(["atlite_tpu_torch", "atlite_tpu_torch.convert", "numpy",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["atlite_tpu.convert", "atlite_tpu_torch"]) == ["atlite_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_unknown_workload_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "no-such-cell",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         cwd=CHECKOUT)
    assert out.returncode != 0 and out.stdout == ""


def test_a_bare_checkout_prints_no_result(tmp_path):
    """BENCHMARK.json and the benchmark's folder alone: without a card it
    stops for the card, on a card for the missing program."""
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "h100_bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "eur03-step",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
