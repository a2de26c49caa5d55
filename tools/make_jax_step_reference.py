"""Store the JAX package's headline step at the bench shape, for the port
to be held against on a machine without JAX.

    JAX_PLATFORMS=cpu python tools/make_jax_step_reference.py [--out PATH]

Runs ``__graft_entry__._step_fn`` under ``jax.jit`` on the CPU with x64
off (float32, as the JAX package runs on its chip) at T=2184, Y=96,
X=128, B=20 on the inputs of ``bench.build_inputs`` (seed 3), the inputs
``chip_smoke.py`` builds with the port's ``build_inputs``, and writes the
two (T, B) float32 outputs with the shape and seed to ``--out`` (default
tests/data_torch/jax_step_bench.npz, about 0.35 MB).  The inputs take
about 3 GB of host memory; tests/test_torch_jax_step_reference.py checks
the stored file against the first hours derived again."""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BENCH_SHAPE = (2184, 96, 128, 20)
SEED = 3


def jax_step(args):
    """The JAX step's (wind_bus, pv_bus) as float32 numpy arrays, x64 off."""
    import jax

    import __graft_entry__ as ge

    with jax.enable_x64(False):
        return [np.asarray(a, dtype=np.float32) for a in jax.jit(ge._step_fn())(*args)]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=ROOT / "tests" / "data_torch"
                        / "jax_step_bench.npz")
    out = parser.parse_args().out
    import jax

    import bench

    t0 = time.perf_counter()
    args = bench.build_inputs(*BENCH_SHAPE, seed=SEED)
    t1 = time.perf_counter()
    wind_bus, pv_bus = jax_step(args)
    t2 = time.perf_counter()
    T, _, _, B = BENCH_SHAPE
    if wind_bus.shape != (T, B) or pv_bus.shape != (T, B):
        raise RuntimeError(f"outputs {wind_bus.shape}, {pv_bus.shape}, want {(T, B)}")
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, wind_bus=wind_bus, pv_bus=pv_bus, shape=np.array(BENCH_SHAPE),
             seed=np.array(SEED))
    print(f"{out}: inputs {t1 - t0:.1f} s, step {t2 - t1:.1f} s on {jax.devices()[0]}, "
          f"jax {jax.__version__}; wind_bus mean {wind_bus.mean():.6g}, pv_bus mean "
          f"{pv_bus.mean():.6g}; {out.stat().st_size} bytes")


if __name__ == "__main__":
    main()
