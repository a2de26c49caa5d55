"""On-disk cutout store (counterpart of ``atlite_tpu/core/store.py``),
interchangeable with the JAX package's byte for byte.

A cutout is a directory:

    <name>.atc/
      manifest.json        coords, crs, attrs, per-variable metadata
      <var>.npy            one array per variable (np.load mmap-able)

``write_store`` writes a temporary directory and swaps it in with
``os.replace`` (the previous store parks in ``<name>.atc.old`` for the
swap); ``update_store`` writes only the named variables, under
content-versioned names ``<var>.<sha8>.npy``, and commits them by
replacing the manifest; ``read_store`` memory-maps the arrays, checks
their sha256 on request and recovers a store left in ``.old``.

Time stamps are written as pandas prints them ("2013-01-01 00:00:00",
with a fraction only when it is nonzero), without pandas; either that
form or numpy's ("2013-01-01T00:00:00.000000000") reads back.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np

MANIFEST = "manifest.json"
SUFFIX = ".atc"


def _sanitize_var(name: str) -> str:
    return name.replace(" ", "__sp__").replace("/", "__sl__")


def _file_digest(fn) -> str:
    """Chunked sha256 of a file (no whole-file bytes object in RAM)."""
    with open(fn, "rb") as fh:
        return hashlib.file_digest(fh, "sha256").hexdigest()


def var_path(path, manifest, name) -> Path:
    """A variable's data file: the manifest's versioned ``file`` entry
    (written by incremental updates) or the plain default."""
    fname = manifest["variables"][name].get("file", f"{_sanitize_var(name)}.npy")
    return Path(path) / fname


def format_times(time) -> list[str]:
    """``datetime64[ns]`` stamps as ``str(pd.Timestamp)`` prints them:
    "YYYY-MM-DD HH:MM:SS", then ".ffffff" when the microseconds are not
    zero, or ".fffffffff" when the nanoseconds are not."""
    t = np.asarray(time, dtype="datetime64[ns]")
    secs = np.datetime_as_string(t.astype("datetime64[s]"), unit="s")
    frac = (t - t.astype("datetime64[s]")).astype(np.int64)
    out = []
    for s, ns in zip(secs.tolist(), frac.tolist()):
        s = s.replace("T", " ")
        if ns % 1000:
            s += f".{ns:09d}"
        elif ns:
            s += f".{ns // 1000:06d}"
        out.append(s)
    return out


def parse_times(strings) -> np.ndarray:
    """``datetime64[ns]`` of stamps written by ``format_times`` or by numpy."""
    return np.array([str(s).strip().replace(" ", "T") for s in strings],
                    dtype="datetime64[ns]").reshape(-1)


def _var_entry(name, arr, var_attrs):
    va = var_attrs.get(name, {})
    return {
        "dims": list(va.get("dims", ("time", "y", "x"))),
        "dtype": str(np.asarray(arr).dtype),
        **{k: _jsonable(v) for k, v in va.items() if k != "dims"},
    }


def write_store(path, grid, data, attrs, var_attrs):
    """Atomically (re)write the cutout directory."""
    path = Path(path)
    parent = path.parent
    parent.mkdir(parents=True, exist_ok=True)
    # sweep tmp dirs orphaned by a hard crash of an earlier write (a
    # continental store's tmp dir is tens of GB); one writer at a time
    for stale in parent.glob(path.name + ".tmp*"):
        if stale.is_dir():
            shutil.rmtree(stale, ignore_errors=True)
    tmp = Path(tempfile.mkdtemp(prefix=path.name + ".tmp", dir=parent))
    try:
        manifest = {
            "coords": {
                "x": [float(v) for v in grid.x],
                "y": [float(v) for v in grid.y],
                "time": format_times(grid.time),
            },
            "crs": grid.crs,
            "attrs": _jsonable(attrs),
            "variables": {name: _var_entry(name, arr, var_attrs) for name, arr in data.items()},
        }
        for name, arr in data.items():
            fn = tmp / f"{_sanitize_var(name)}.npy"
            np.save(fn, np.asarray(arr))
            manifest["variables"][name]["sha256"] = _file_digest(fn)
        (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
        old = Path(str(path) + ".old")
        if old.exists():
            # a backup left by an interrupted swap would make
            # os.replace(path, old) fail with ENOTEMPTY
            shutil.rmtree(old)
        if path.exists():
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def update_store(path, grid, data, attrs, var_attrs, update_vars):
    """Add or replace the variables ``update_vars`` in an existing store.

    Only their files are written, each under a content-versioned name
    (``<var>.<sha8>.npy``) that the manifest's ``file`` entry names, so
    replacing the manifest is the single commit point: a crash before it
    leaves the previous manifest and its intact files.  Files the
    committed manifest no longer names are removed.  A store with other
    coords or crs, or without a variable of ``data`` that is not being
    written, is rewritten whole.
    """
    path = Path(path)
    if not path.exists():
        write_store(path, grid, data, attrs, var_attrs)
        return
    manifest = json.loads((path / MANIFEST).read_text())
    stored = manifest["coords"]
    if (len(stored["x"]) != len(grid.x) or len(stored["y"]) != len(grid.y)
            or len(stored["time"]) != len(grid.time)
            or not np.allclose(stored["x"], grid.x)
            or not np.allclose(stored["y"], grid.y)
            or (parse_times(stored["time"])
                != np.asarray(grid.time, dtype="datetime64[ns]")).any()
            or manifest.get("crs", 4326) != grid.crs):
        write_store(path, grid, data, attrs, var_attrs)
        return
    update_vars = set(update_vars)
    if set(data) - set(manifest["variables"]) - update_vars:
        write_store(path, grid, data, attrs, var_attrs)
        return
    for name in sorted(update_vars):
        arr = np.asarray(data[name])
        fd, tmpname = tempfile.mkstemp(prefix=_sanitize_var(name), suffix=".tmp", dir=path)
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            digest = _file_digest(tmpname)
            fname = f"{_sanitize_var(name)}.{digest[:8]}.npy"
            os.replace(tmpname, path / fname)
        except BaseException:
            if os.path.exists(tmpname):
                os.unlink(tmpname)
            raise
        manifest["variables"][name] = {**_var_entry(name, arr, var_attrs),
                                       "sha256": digest, "file": fname}
    manifest["attrs"] = _jsonable(attrs)
    fd, tmpname = tempfile.mkstemp(prefix=MANIFEST, suffix=".tmp", dir=path)
    with os.fdopen(fd, "w") as f:
        f.write(json.dumps(manifest, indent=1))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmpname, path / MANIFEST)  # the single commit point
    # remove superseded versions and the orphans of an earlier crash
    # (.tmp: a hard crash between mkstemp and os.replace)
    live = {var_path(path, manifest, n).name for n in manifest["variables"]}
    live.add(MANIFEST)
    for fn in path.iterdir():
        if fn.name not in live and fn.suffix in (".npy", ".tmp"):
            try:
                fn.unlink()
            except OSError:
                pass


def read_store(path, mmap=True, verify=False):
    """Load a cutout directory: ``(grid_kwargs, data, attrs, var_attrs)``,
    the arrays memory-mapped read-only by default.  ``verify=True``
    checks every file against the manifest's sha256."""
    path = Path(path)
    old = Path(str(path) + ".old")
    if not path.exists() and old.exists():
        # a write stopped between its two swaps: the previous, complete
        # store is in '.old'
        os.replace(old, path)
    manifest = json.loads((path / MANIFEST).read_text())
    data, var_attrs = {}, {}
    for name, meta in manifest["variables"].items():
        fn = var_path(path, manifest, name)
        if verify and "sha256" in meta and _file_digest(fn) != meta["sha256"]:
            raise IOError(f"checksum mismatch for variable {name!r} in {path} — store is "
                          "corrupted or was written by an interrupted process")
        data[name] = np.load(fn, mmap_mode="r" if mmap else None)
        var_attrs[name] = {k: v for k, v in meta.items() if k not in ("dtype", "sha256", "file")}
    coords = manifest["coords"]
    grid_kwargs = dict(
        x=np.asarray(coords["x"], dtype=float),
        y=np.asarray(coords["y"], dtype=float),
        time=parse_times(coords["time"]),
        crs=manifest.get("crs", 4326),
    )
    return grid_kwargs, data, manifest.get("attrs", {}), var_attrs


def _jsonable(v):
    if isinstance(v, np.bool_):
        return bool(v)  # before np.integer: np.bool_ is neither
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.datetime64) or (isinstance(v, datetime.datetime)
                                        and hasattr(v, "nanosecond")):
        return str(v)  # numpy's form, or a pandas Timestamp's own
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v
