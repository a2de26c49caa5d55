"""Modules found by name under the benchmark's folder, so that a cell, an
entry, a reference or a metric comes with files of its own and no file
that is there needs an edit:

- ``entries/<entry>.py``: how the traffic's ``entry`` is driven and
  judged (``build``, ``reference``, ``answers``, ``limit``);
- ``reference/<method>.py``: the plain reference of one converter
  method (``FIELDS``, ``cell_values``, ``LIMIT``);
- ``metrics/<metric>.py``: one metric's reader (``read``).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]  # the benchmark's folder
_LOADED = {}


def module(folder, name, bench=BENCH):
    """The module ``<bench>/<folder>/<name>.py``, loaded once a path."""
    path = (Path(bench) / folder / f"{name}.py").resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise KeyError(f"no {folder}/{name}.py under {bench}")
        key = "h100_bench_" + "_".join(
            "".join(ch if ch.isalnum() else "_" for ch in part) for part in (folder, name))
        spec = importlib.util.spec_from_file_location(f"{key}_{len(_LOADED)}", path)
        loaded = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(loaded)
        _LOADED[path] = loaded
    return _LOADED[path]
