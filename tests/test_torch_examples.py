"""Every example of the port (``examples_torch/*.py``) runs to its end
with ``--device cpu``, in a subprocess that refuses to import jax, the
JAX package, pandas and the other libraries the port does without
(``tests/test_torch_entry.py``'s list), and prints something.

The examples start together (one thread each) when the first test asks
for them, so the file takes about as long as the slowest example."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
BANNED = ("jax", "jaxlib", "atlite_tpu", "pandas", "yaml", "rasterio", "h5py", "netCDF4",
          "xarray")
RUN = """
import importlib.abc, runpy, sys
BANNED = {banned!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = [{path!r}, "--device", "cpu"]
runpy.run_path({path!r}, run_name="__main__")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
"""


@pytest.fixture(scope="module")
def runs():
    """{example name: Popen} of every example, started together."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", MPLBACKEND="Agg")
    procs = {p.stem: subprocess.Popen(
        [sys.executable, "-c", RUN.format(banned=BANNED, path=str(p))], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for p in EXAMPLES}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_every_example_has_a_counterpart():
    assert {p.stem for p in EXAMPLES} == {p.stem for p in (ROOT / "examples").glob("*.py")}


@pytest.mark.parametrize("name", [p.stem for p in EXAMPLES])
def test_example_runs_on_the_port_alone(runs, name):
    out, err = runs[name].communicate(timeout=300)
    assert runs[name].returncode == 0, (f"{name} failed (rc={runs[name].returncode})\n"
                                        f"--- stdout ---\n{out[-3000:]}\n"
                                        f"--- stderr ---\n{err[-3000:]}")
    assert out.strip(), f"{name} printed nothing"
