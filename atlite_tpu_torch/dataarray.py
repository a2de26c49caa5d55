"""Minimal labeled array of the conversion results (counterpart of
``atlite_tpu/dataarray.py``, without pandas).

``values`` is a torch tensor (on the device that computed it) or a numpy
array; ``coords`` are numpy arrays, time as ``datetime64[ns]``.  It
carries only what ``convert_and_aggregate`` needs: sizes, copies,
``load``/``to_numpy`` to the host, and ``sum``/``mean`` over a dimension
with xarray's skipna rule.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def _coord(v):
    """A coordinate as a numpy array; stamps as datetime64[ns]."""
    a = np.asarray(v)
    return a.astype("datetime64[ns]") if a.dtype.kind == "M" else a


class DataArray:
    """Labeled array: ``values`` + ``dims`` + per-dim ``coords`` + ``attrs``."""

    __slots__ = ("values", "dims", "coords", "attrs", "name")

    def __init__(self, values, coords=None, dims=None, attrs=None, name=None):
        if not isinstance(values, torch.Tensor):
            values = np.asarray(values)
        coords = dict(coords or {})
        dims = tuple(coords) if dims is None else tuple(dims)
        self.values = values
        self.dims = dims
        self.coords = {k: _coord(v) for k, v in coords.items()}
        self.attrs = dict(attrs or {})
        self.name = name
        if len(self.dims) != values.ndim:
            raise ValueError(f"dims {self.dims} do not match shape {tuple(values.shape)}")
        for d in self.dims:
            if d in self.coords and len(self.coords[d]) != self.sizes[d]:
                raise ValueError(f"coord {d} length mismatch")

    @property
    def shape(self):
        return tuple(self.values.shape)

    @property
    def sizes(self):
        return dict(zip(self.dims, self.values.shape))

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

    def _reduce(self, fn, nanfn, dim, keep_attrs=True, skipna=None):
        # xarray semantics: skipna defaults to True for float data
        v = self.to_numpy()
        if skipna or (skipna is None and np.issubdtype(v.dtype, np.inexact)):
            fn = nanfn
        if dim is None:
            return fn(v)
        axis = self.dims.index(dim)
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            # all-NaN slices reduce to NaN, as in xarray
            warnings.filterwarnings("ignore", r"Mean of empty slice|"
                                    r"All-NaN (slice|axis) encountered", RuntimeWarning)
            values = fn(v, axis=axis)
        return DataArray(values, coords={d: c for d, c in self.coords.items() if d != dim},
                         dims=tuple(d for d in self.dims if d != dim),
                         attrs=self.attrs if keep_attrs else None, name=self.name)

    def sum(self, dim=None, **kw):
        return self._reduce(np.sum, np.nansum, dim, **kw)

    def mean(self, dim=None, **kw):
        return self._reduce(np.mean, np.nanmean, dim, **kw)
