"""Build the CUDA sources in ``csrc/`` into shared libraries, at first use.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``build/kernels/lib<name>_<hash>.so`` at the root of the checkout, where
``<hash>`` covers the source and the compiler flags, so an edited source
is rebuilt and a stale library is never loaded.  All sources compile in
parallel, one ``nvcc`` each.  ``nvcc`` comes from ``$PATH`` or
``/usr/local/cuda/bin``; when it is missing, or a build fails, this raises:
there is no other route to the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError(
            "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA "
            "kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives once built."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no library yet, in parallel.
    Returns {name: library path}; ``nvcc``'s output (register and shared
    memory use) is kept beside each library as ``<library>.log``."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not library_path(n).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in todo:
            out = library_path(name)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            log = open(f"{out}.log", "w+", encoding="utf-8")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
            jobs.append((name, out, tmp, log, proc))
        failed = []
        for name, out, tmp, log, proc in jobs:
            with log:
                rc = proc.wait()
                log.seek(0)
                if rc == 0:
                    os.replace(tmp, out)
                else:
                    os.unlink(tmp)
                    failed.append(f"{name}.cu (nvcc exit {rc}):\n{log.read()}")
        if failed:
            raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return {n: library_path(n) for n in names}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build_all()[name]))
