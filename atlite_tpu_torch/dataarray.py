"""Minimal labeled array of the conversion results (counterpart of
``atlite_tpu/dataarray.py``), without pandas.

``values`` is a torch tensor (on the device that computed it) or a numpy
array; ``coords`` are numpy arrays, time as ``datetime64[ns]``.
Selection (``isel``, ``sel``) indexes a tensor where it lies, elementwise
methods and operators keep it on its device, and reductions run on the
host (``to_numpy``), with xarray's skipna rule.  ``sel`` follows pandas'
``.loc``: inclusive label slices in either sort order of the coordinate,
partial time labels ("2013-01" is the whole month), ``method="nearest"``
and lists of labels.  ``to_pandas`` and ``plot`` import pandas and
matplotlib only when they are called.
"""

from __future__ import annotations

import operator
import re
import warnings

import numpy as np
import torch


def _coord(v):
    """A coordinate as a numpy array; stamps as datetime64[ns]."""
    a = np.asarray(v)
    return a.astype("datetime64[ns]") if a.dtype.kind == "M" else a


def _like(x, ref):
    """``x`` as the kind of array ``ref`` is: a tensor on ``ref``'s device,
    or numpy; scalars pass as they are."""
    if isinstance(x, DataArray):
        x = x.values
    if isinstance(ref, torch.Tensor):
        if isinstance(x, torch.Tensor):
            return x.to(ref.device)
        if isinstance(x, (np.ndarray, list, tuple)):
            return torch.as_tensor(np.asarray(x), device=ref.device)
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


class DataArray:
    """Labeled array: ``values`` + ``dims`` + per-dim ``coords`` + ``attrs``."""

    __slots__ = ("values", "dims", "coords", "attrs", "name")

    def __init__(self, values, coords=None, dims=None, attrs=None, name=None):
        if not isinstance(values, torch.Tensor):
            values = np.asarray(values)
        if isinstance(coords, (list, tuple)):
            coords = dict(coords)
        coords = dict(coords or {})
        if dims is None:
            dims = tuple(coords) if coords else tuple(f"dim_{i}" for i in range(values.ndim))
        self.values = values
        self.dims = tuple(dims)
        self.coords = {k: _coord(v) for k, v in coords.items()}
        self.attrs = dict(attrs or {})
        self.name = name
        if len(self.dims) != values.ndim:
            raise ValueError(f"dims {self.dims} do not match shape {tuple(values.shape)}")
        for d in self.dims:
            if d in self.coords and len(self.coords[d]) != self.sizes[d]:
                raise ValueError(f"coord {d} length mismatch")

    # -- basic introspection -------------------------------------------------
    @property
    def shape(self):
        return tuple(self.values.shape)

    @property
    def ndim(self):
        return self.values.ndim

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.values.shape))

    def get_axis_num(self, dim):
        return self.dims.index(dim)

    def __len__(self):
        return self.values.shape[0]

    def __repr__(self):
        cs = ", ".join(f"{d}: {s}" for d, s in self.sizes.items())
        return f"<atlite_tpu_torch.DataArray {self.name or ''}({cs})>\n{self.values!r}"

    def copy(self, values=None):
        if values is None:
            values = (self.values.clone() if isinstance(self.values, torch.Tensor)
                      else self.values.copy())
        return DataArray(values, coords=self.coords, dims=self.dims, attrs=self.attrs,
                         name=self.name)

    def to_numpy(self):
        """The values as a host numpy array."""
        if isinstance(self.values, torch.Tensor):
            return self.values.detach().cpu().numpy()
        return np.asarray(self.values)

    def load(self):
        """Bring device values to the host, in place."""
        self.values = self.to_numpy()
        return self

    def rename(self, name):
        da = self.copy(self.values)
        da.name = name
        return da

    def assign_attrs(self, **attrs):
        self.attrs.update(attrs)
        return self

    # -- selection -----------------------------------------------------------
    def isel(self, **indexers):
        """Positional selection, one axis at a time (outer selection): an
        integer drops its dim, a slice, integer list or boolean mask keeps
        it."""
        values = self.values
        dims = list(self.dims)
        coords = dict(self.coords)
        items = sorted(indexers.items(), key=lambda kv: self.get_axis_num(kv[0]), reverse=True)
        for d, i in items:
            ax = dims.index(d)
            if isinstance(i, slice):
                values = _take(values, i, ax)
                if d in coords:
                    coords[d] = coords[d][i]
            elif isinstance(i, (int, np.integer)):
                values = _take(values, int(i), ax)
                dims.pop(ax)
                coords.pop(d, None)
            else:
                i = np.asarray(i)
                if i.dtype == bool:
                    i = np.flatnonzero(i)
                values = _take(values, i, ax)
                if d in coords:
                    coords[d] = coords[d][i]
        return DataArray(values, coords=coords, dims=dims, attrs=self.attrs, name=self.name)

    def sel(self, method=None, **indexers):
        """Label selection with pandas' ``.loc`` rules (see the module
        docstring); ``method="nearest"`` for scalars and lists."""
        isels = {}
        for d, v in indexers.items():
            vals = self.coords[d]
            if vals.dtype.kind == "M":
                isels[d] = _sel_time(vals, v, method)
            else:
                isels[d] = _sel_labels(vals, v, method)
        return self.isel(**isels)

    def transpose(self, *dims):
        axes = [self.get_axis_num(d) for d in dims]
        v = self.values
        v = v.permute(axes) if isinstance(v, torch.Tensor) else np.transpose(v, axes)
        return DataArray(v, coords=self.coords, dims=dims, attrs=self.attrs, name=self.name)

    # -- reductions ----------------------------------------------------------
    def _reduce(self, fn, nanfn, dim, keep_attrs=True, skipna=None, **kw):
        # xarray semantics: skipna defaults to True for float data
        v = self.to_numpy()
        if skipna or (skipna is None and np.issubdtype(v.dtype, np.inexact)):
            fn = nanfn
        if dim is None:
            return fn(v, **kw)
        axis = self.get_axis_num(dim)
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            # all-NaN slices reduce to NaN, as in xarray
            warnings.filterwarnings("ignore", r"Mean of empty slice|"
                                    r"All-NaN (slice|axis) encountered", RuntimeWarning)
            values = fn(v, axis=axis, **kw)
        return DataArray(values, coords={d: c for d, c in self.coords.items() if d != dim},
                         dims=tuple(d for d in self.dims if d != dim),
                         attrs=self.attrs if keep_attrs else None, name=self.name)

    def sum(self, dim=None, **kw):
        return self._reduce(np.sum, np.nansum, dim, **kw)

    def mean(self, dim=None, **kw):
        return self._reduce(np.mean, np.nanmean, dim, **kw)

    def min(self, dim=None, **kw):
        return self._reduce(np.min, np.nanmin, dim, **kw)

    def max(self, dim=None, **kw):
        return self._reduce(np.max, np.nanmax, dim, **kw)

    def quantile(self, q):
        return np.quantile(self.to_numpy(), q)

    # -- elementwise ---------------------------------------------------------
    def clip(self, min=None, max=None):
        v = self.values
        if isinstance(v, torch.Tensor):
            return self.copy(torch.clamp(v, min=min, max=max))
        return self.copy(np.clip(v, min, max))

    def _aligned(self, x, what):
        """A DataArray operand broadcast to this array's dims by name (its
        dims must be among them, with equal coords); anything else as it
        is."""
        if not isinstance(x, DataArray):
            return x
        for d in x.dims:
            if d not in self.dims:
                raise ValueError(f"{what} operand has dimension {d!r} absent from the array "
                                 f"{self.dims}")
            if (d in self.coords and d in x.coords
                    and not np.array_equal(self.coords[d], x.coords[d])):
                raise ValueError(f"coordinate {d!r} differs between {what} operands; align "
                                 "with sel()/isel() first")
        return _expand(x.values, x.dims, list(self.dims))

    def where(self, cond, other=np.nan):
        """Values where ``cond`` holds, else ``other``; DataArray operands
        broadcast by dim name."""
        v = self.values
        cond = _like(self._aligned(cond, "where()"), v)
        other = _like(self._aligned(other, "where()"), v)
        if isinstance(v, torch.Tensor):
            return self.copy(torch.where(torch.as_tensor(cond, device=v.device).bool(), v, other))
        return self.copy(np.where(cond, v, other))

    def fillna(self, value):
        """NaN replaced by ``value`` (a DataArray broadcasts by dim name);
        integer and boolean data, which hold no NaN, come back as they
        are."""
        v = self.values
        if isinstance(v, torch.Tensor):
            if not (v.is_floating_point() or v.is_complex()):
                return self.copy(v)
            return self.copy(torch.where(torch.isnan(v), _like(self._aligned(value, "fillna()"),
                                                                v), v))
        if not (np.issubdtype(v.dtype, np.floating) or np.issubdtype(v.dtype, np.complexfloating)):
            return self.copy(v)
        return self.copy(np.where(np.isnan(v), _like(self._aligned(value, "fillna()"), v), v))

    def rolling_mean(self, dim, window, min_periods=1):
        """Trailing rolling mean over ``window`` steps of ``dim`` that skips
        NaN (xarray's ``rolling(dim=window, min_periods=...).mean()``): a
        NaN leaves both the window's sum and its count; a window with
        fewer than ``min_periods`` values is NaN.  Float64, on the host."""
        window = int(window)
        if window < 1:
            raise ValueError(f"rolling_mean window must be >= 1, got {window}")
        axis = self.dims.index(dim)
        # the window runs along the last, contiguous axis
        v = np.ascontiguousarray(np.moveaxis(np.asarray(self.to_numpy(), dtype=float), axis, -1))
        valid = ~np.isnan(v)
        # window sum at step i: csum[i] - csum[i - window]
        s = np.cumsum(np.where(valid, v, 0.0), axis=-1)
        c = np.cumsum(valid, axis=-1, dtype=np.int64)
        if window < s.shape[-1]:
            s[..., window:] -= s[..., :-window].copy()
            c[..., window:] -= c[..., :-window].copy()
        with np.errstate(invalid="ignore"):
            out = np.where(c >= max(min_periods, 1), s / np.maximum(c, 1), np.nan)
        return self.copy(np.moveaxis(out, -1, axis))

    # -- arithmetic with dim-name broadcasting --------------------------------
    def _binop(self, other, fn, reflexive=False):
        if isinstance(other, DataArray):
            # shared dims must carry identical coordinates: combining
            # positionally across reordered coords gives wrong numbers
            for d in self.dims:
                if (d in other.dims and d in self.coords and d in other.coords
                        and not np.array_equal(self.coords[d], other.coords[d])):
                    raise ValueError(f"coordinate {d!r} differs between operands; align with "
                                     "sel()/isel() first")
            dims = list(self.dims) + [d for d in other.dims if d not in self.dims]
            a = _expand(self.values, self.dims, dims)
            b = _expand(other.values, other.dims, dims)
            if isinstance(b, torch.Tensor) and not isinstance(a, torch.Tensor):
                a = _like(a, b)
            b = _like(b, a)
            values = fn(b, a) if reflexive else fn(a, b)
            return DataArray(values, coords={**other.coords, **self.coords}, dims=dims,
                             attrs=self.attrs, name=self.name)
        a = self.values
        if isinstance(other, torch.Tensor) and not isinstance(a, torch.Tensor):
            a = _like(a, other)
        other = _like(other, a)
        return self.copy(fn(other, a) if reflexive else fn(a, other))

    def __add__(self, o):
        return self._binop(o, operator.add)

    def __radd__(self, o):
        return self._binop(o, operator.add, True)

    def __sub__(self, o):
        return self._binop(o, operator.sub)

    def __rsub__(self, o):
        return self._binop(o, operator.sub, True)

    def __mul__(self, o):
        return self._binop(o, operator.mul)

    def __rmul__(self, o):
        return self._binop(o, operator.mul, True)

    def __truediv__(self, o):
        return self._binop(o, operator.truediv)

    def __rtruediv__(self, o):
        return self._binop(o, operator.truediv, True)

    def __pow__(self, o):
        return self._binop(o, operator.pow)

    def __neg__(self):
        return self.copy(-self.values)

    def __ge__(self, o):
        return self._binop(o, operator.ge)

    def __le__(self, o):
        return self._binop(o, operator.le)

    def __gt__(self, o):
        return self._binop(o, operator.gt)

    def __lt__(self, o):
        return self._binop(o, operator.lt)

    def __eq__(self, o):
        # elementwise, as in xarray; DataArrays are therefore unhashable
        return self._binop(o, operator.eq)

    def __ne__(self, o):
        return self._binop(o, operator.ne)

    __hash__ = None

    # -- plotting and export ----------------------------------------------------
    def plot(self, ax=None, **kwargs):
        """Quick matplotlib plot: pcolormesh for 2-D (e.g. (y, x) fields),
        a line for 1-D series."""
        import matplotlib.pyplot as plt

        if ax is None:
            ax = plt.gca()
        v = self.to_numpy()
        if self.ndim == 2:
            d0, d1 = self.dims
            x = self.coords[d1] if d1 in self.coords else np.arange(v.shape[1])
            y = self.coords[d0] if d0 in self.coords else np.arange(v.shape[0])
            m = ax.pcolormesh(x, y, v, **kwargs)
            ax.set_xlabel(d1)
            ax.set_ylabel(d0)
            plt.colorbar(m, ax=ax, label=self.attrs.get("units"))
            return m
        if self.ndim == 1:
            d0 = self.dims[0]
            x = self.coords[d0] if d0 in self.coords else np.arange(len(v))
            line, = ax.plot(x, v, **kwargs)
            ax.set_xlabel(d0)
            ax.set_ylabel(self.attrs.get("units", self.name or ""))
            return line
        raise ValueError("plot supports only 1-D/2-D arrays; use isel/sel first")

    def to_pandas(self):
        """A pandas Series (1-D) or DataFrame (2-D); imports pandas."""
        import pandas as pd

        v = self.to_numpy()
        index = self.coords.get(self.dims[0]) if self.ndim else None
        if self.ndim == 1:
            return pd.Series(v, index=index, name=self.name)
        if self.ndim == 2:
            return pd.DataFrame(v, index=index, columns=self.coords.get(self.dims[1]))
        raise ValueError("to_pandas supports only 1-D/2-D arrays")


def _take(values, i, ax):
    """``values`` indexed along axis ``ax`` by an int, a slice or an
    integer array, numpy or a tensor where it lies."""
    if not isinstance(values, torch.Tensor):
        if isinstance(i, slice):
            return values[(slice(None),) * ax + (i,)]
        return np.take(values, i, axis=ax)
    n = values.shape[ax]
    if isinstance(i, int):
        return values.select(ax, i)
    if isinstance(i, slice):
        if i.step is None or i.step > 0:
            return values[(slice(None),) * ax + (i,)]
        i = np.arange(n)[i]  # tensors take no negative step
    i = np.where(i < 0, i + n, i)
    return torch.index_select(values, ax, torch.as_tensor(i, dtype=torch.long,
                                                          device=values.device))


def _expand(values, dims, target_dims):
    """``values`` with ``dims`` transposed and reshaped to broadcast over
    ``target_dims``."""
    dims = tuple(dims)
    order = [d for d in target_dims if d in dims]
    axes = [dims.index(d) for d in order]
    values = values.permute(axes) if isinstance(values, torch.Tensor) else \
        np.transpose(np.asarray(values), axes)
    shape = [values.shape[order.index(d)] if d in order else 1 for d in target_dims]
    return values.reshape(shape)


# ---------------------------------------------------------------------------
# label lookup (pandas' Index.get_loc / get_indexer / slice_locs)
# ---------------------------------------------------------------------------
def _monotonic(vals):
    """(increasing, decreasing) of a coordinate."""
    if len(vals) < 2:
        return True, True
    return bool((vals[1:] >= vals[:-1]).all()), bool((vals[1:] <= vals[:-1]).all())


def _lookup(vals, labels):
    """Position of each label among ``vals`` (-1 when absent); the
    coordinate must hold each value once."""
    labels = np.asarray(labels)
    if len(np.unique(vals)) != len(vals):
        raise ValueError("Reindexing only valid with uniquely valued Index objects")
    if not len(vals):
        return np.full(labels.shape, -1)
    sorter = np.argsort(vals, kind="stable")
    sv = vals[sorter]
    i = np.clip(np.searchsorted(sv, labels), 0, len(vals) - 1)
    return np.where(sv[i] == labels, sorter[i], -1)


def _nearest(vals, labels):
    """pandas' ``get_indexer(labels, method="nearest")``: the nearer of the
    neighbours on either side (on a tie, the one an increasing coordinate
    has after the label, a decreasing one before it)."""
    labels = np.asarray(labels)
    inc, dec = _monotonic(vals)
    if not (inc or dec):
        raise ValueError("index must be monotonic increasing or decreasing")
    n = len(vals)
    exact = _lookup(vals, labels)
    if inc:
        left = np.searchsorted(vals, labels, "right") - 1
        right = np.searchsorted(vals, labels, "left")
    else:
        rev = vals[::-1]
        left = n - np.searchsorted(rev, labels, "right") - 1
        right = n - np.searchsorted(rev, labels, "left")
    left = np.where(exact >= 0, exact, left)
    right = np.where(exact >= 0, exact, np.where(right == n, -1, right))

    def dist(pos):
        d = vals[pos] - labels  # position -1 reads the last value, as pandas does
        return np.abs(d.astype(np.int64) if d.dtype.kind == "m" else d)

    closer = (dist(left) < dist(right)) if inc else (dist(left) <= dist(right))
    return np.where(closer | (right == -1), left, right)


def _get_loc(vals, label):
    """An int for a label held once, the positions of one held more often;
    KeyError when absent."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hit = np.flatnonzero(np.asarray(vals == label))
    if len(hit) == 0:
        raise KeyError(label)
    return int(hit[0]) if len(hit) == 1 else hit


def _sel_labels(vals, v, method):
    """Positions for one non-time coordinate's indexer."""
    if isinstance(v, slice):
        # pandas .loc: start is the first label in traversal order (index
        # order, reversed for a negative step), bounds inclusive, and a
        # misordered pair selects nothing
        neg = v.step is not None and v.step < 0
        desc = len(vals) > 1 and vals[0] > vals[-1]
        upper, lower = (v.start, v.stop) if desc != neg else (v.stop, v.start)
        mask = np.ones(len(vals), dtype=bool)
        if lower is not None:
            mask &= vals >= lower
        if upper is not None:
            mask &= vals <= upper
        pos = np.flatnonzero(mask)
        if neg:
            pos = pos[::-1]
        if v.step is not None and abs(v.step) != 1:
            pos = pos[::abs(v.step)]
        return pos
    if np.ndim(v) == 0:
        if method == "nearest":
            return int(_nearest(vals, [v])[0])
        return _get_loc(vals, v)
    return _positions(vals, np.asarray(v), method)


def _positions(vals, labels, method):
    pos = _nearest(vals, labels) if method == "nearest" else _lookup(vals, labels)
    if method is None and (pos < 0).any():
        raise KeyError(f"labels {labels[pos < 0].tolist()} not found in coordinate")
    return pos


# time labels: a partial ISO string stands for its whole period
_ISO = re.compile(r"(\d{4})(?:-(\d{1,2})(?:-(\d{1,2})(?:[ T](\d{1,2})(?::(\d{2})"
                  r"(?::(\d{2})(?:\.(\d{1,9}))?)?)?)?)?)?")
# pandas' Resolution order, finest first
_RESO = {"ns": 0, "us": 1, "ms": 2, "s": 3, "m": 4, "h": 5, "D": 6, "M": 7, "Y": 9}


def _parse_period(label):
    """(start, end, resolution) of a time label: a partial ISO string
    spans its period ("2013-01" the whole month, "2013-01-02 05:00" one
    minute); anything else is an instant."""
    m = _ISO.fullmatch(label.strip()) if isinstance(label, str) else None
    if m is None:
        t = np.datetime64(label.strip().replace(" ", "T") if isinstance(label, str) else label,
                          "ns")
        return t, t, "ns"
    y, mo, d, h, mi, s, frac = m.groups()
    parts = [p for p in (mo, d, h, mi, s) if p is not None]
    unit = ("Y", "M", "D", "h", "m", "s")[len(parts)]
    stamp = f"{y}-{int(mo or 1):02d}-{int(d or 1):02d}T{int(h or 0):02d}:{int(mi or 0):02d}:" \
            f"{int(s or 0):02d}"
    start = np.datetime64(stamp, "ns")
    if frac is not None:
        unit = "ms" if len(frac) <= 3 else "us" if len(frac) <= 6 else "ns"
        start = start + np.timedelta64(int(frac.ljust(9, "0")), "ns")
    if unit in ("Y", "M"):
        nxt = np.datetime64(start.astype(f"datetime64[{unit}]") + 1, "ns")
    else:
        nxt = start + np.timedelta64(1, unit).astype("timedelta64[ns]")
    return start, nxt - np.timedelta64(1, "ns"), unit


def _instant(label):
    return _parse_period(label)[0] if isinstance(label, str) else np.datetime64(label, "ns")


def _resolution(vals):
    """pandas' resolution of the stamps: the finest unit any of them uses
    (days when all fall on midnight)."""
    i8 = vals.astype(np.int64)
    if (i8 % 1000).any():
        return "ns"
    us = (i8 // 1000) % 10**6
    if us.any():
        return "us" if (us % 1000).any() else "ms"
    for unit, step, n in (("s", 10**9, 60), ("m", 60 * 10**9, 60), ("h", 3600 * 10**9, 24)):
        if ((i8 // step) % n).any():
            return unit
    return "D"


def _searchsorted_monotonic(vals, label, side, inc):
    if inc:
        return int(np.searchsorted(vals, label, side))
    other = "right" if side == "left" else "left"
    return len(vals) - int(np.searchsorted(vals[::-1], label, other))


def _sel_time(vals, v, method):
    """Positions for one time coordinate's indexer."""
    n = len(vals)
    inc, dec = _monotonic(vals)
    if isinstance(v, slice):
        start, stop, step = v.start, v.stop, v.step
        if not (inc or dec):
            # pandas: value-based selection, and only with labels it holds
            mask, held = np.ones(n, dtype=bool), True
            if start is not None:
                lo = _parse_period(start)[0]
                mask &= vals >= lo
                held &= bool((vals == lo).any())
            if stop is not None:
                hi = _parse_period(stop)[1]
                mask &= vals <= hi
                held &= bool((vals == hi).any())
            if not held:
                raise KeyError("Value based partial slicing on non-monotonic DatetimeIndexes "
                               "with non-existing keys is not allowed.")
            return np.flatnonzero(mask)[::step]
        if step is not None and step < 0:
            start, stop = stop, start
        a = 0 if start is None else _searchsorted_monotonic(vals, _parse_period(start)[0],
                                                            "left", inc)
        b = n if stop is None else _searchsorted_monotonic(vals, _parse_period(stop)[1],
                                                           "right", inc)
        if step is not None and step < 0:
            b, a = a - 1, b - 1
            b = b - n if b == -1 else b
            a = a - n if a == -1 else a
        return np.arange(n)[slice(a, b, step)]
    if np.ndim(v) == 0:
        if method == "nearest":
            return int(_nearest(vals, [_instant(v)])[0])
        if isinstance(v, str):
            start, end, unit = _parse_period(v)
            if _RESO[unit] > _RESO[_resolution(vals)]:
                if not inc:
                    return np.flatnonzero((vals >= start) & (vals <= end))
                if n and ((end < vals[0]) or (start > vals[-1])):
                    raise KeyError(v)
                return np.arange(np.searchsorted(vals, start, "left"),
                                 np.searchsorted(vals, end, "right"))
            return _get_loc(vals, start)
        return _get_loc(vals, np.datetime64(v, "ns"))
    labels = np.array([_instant(x) for x in np.asarray(v).ravel()], dtype="datetime64[ns]")
    return _positions(vals, labels, method)
