"""The benchmark of atlite_tpu_torch on NVIDIA cards.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(inputs made from the seed, the Cutout built and staged, one warm call of
each kind), a closed loop of calls for ``--seconds``, with ``--trace 1``
a traced stretch after it, then the comparison with the plain reference.
The last line of standard output is the result as JSON; the numbers
compared, each beside its limit, are the last lines of standard error.
Exit codes: 2 bad arguments, 3 no card (or fewer than the cell needs),
4 the program or the benchmark's files are missing, 5 JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# the kernel caches stay at fixed places inside the checkout, so that only
# a checkout's first run builds (the port builds its nvcc libraries into
# build/kernels/ beside these)
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
sys.path.insert(0, str(CHECKOUT))


def fail(code, msg):
    print(f"h100_bench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec_path = CHECKOUT / "BENCHMARK.json"
    if not spec_path.is_file():
        fail(4, f"{spec_path} is missing")
    spec = json.loads(spec_path.read_text())
    try:
        import torch
        from h100_bench.harness import bench
        from h100_bench.harness.guard import forbidden_modules
        cell, config, traffic, e2e, layer = bench.resolve(args.workload, spec)
    except (ImportError, OSError, KeyError) as exc:
        fail(4, f"cannot load the benchmark: {exc!r}")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        fail(3, f"{cell['name']} needs {cell['chips']} CUDA card(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    try:
        import atlite_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(4, f"the program atlite_tpu_torch cannot be imported: {exc!r}")

    result, checks = bench.run_cell(cell, config, traffic, e2e, layer, args.seed,
                                    args.seconds, args.trace, "cuda:0", t_start=T_START)
    found = forbidden_modules()
    if found:
        fail(5, f"JAX or the JAX package was loaded: {', '.join(found)}")
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
