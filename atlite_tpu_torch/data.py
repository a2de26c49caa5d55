"""Preparation engine — module-level API (counterpart of
``atlite_tpu/data.py``; atlite's data.py).

The implementation lives on the Cutout (``Cutout.prepare``); these
wrappers expose atlite's module-level functions with the same semantics:
per-feature diff of available vs prepared variables, fetch only what is
missing, a checkpoint per feature.  ``available_features`` returns the
port's ``Table`` (``to_pandas()`` gives the JAX package's Series).
"""

from __future__ import annotations

import numpy as np

from atlite_tpu_torch.datasets import modules as datamodules
from atlite_tpu_torch.table import Table


def non_bool_dict(d):
    """Convert bools to ints for attrs storage (atlite data.py:107-111)."""
    return {k: int(v) if isinstance(v, bool) else v for k, v in d.items()}


def maybe_remove_tmpdir(func):
    """Create-and-clean a tmpdir around ``func`` when the caller passes none
    (atlite data.py:114-129)."""
    from functools import wraps
    from shutil import rmtree
    from tempfile import mkdtemp

    @wraps(func)
    def wrapper(*args, **kwargs):
        if kwargs.get("tmpdir", None):
            return func(*args, **kwargs)
        kwargs["tmpdir"] = mkdtemp()
        try:
            return func(*args, **kwargs)
        finally:
            rmtree(kwargs["tmpdir"])

    return wrapper


def available_features(module=None):
    """(module, feature) -> variable Table (atlite data.py:76-104)."""
    rows = [((name, feature), var) for name, mod in datamodules.items()
            if module is None or name in np.atleast_1d(module)
            for feature, variables in mod.features.items() for var in variables]
    return Table({"variable": [v for _, v in rows]}, index=[k for k, _ in rows],
                 index_names=("module", "feature"), series=True)


def get_features(cutout, module, features, data_format=None, tmpdir=None,
                 monthly_requests=False, concurrent_requests=False, **params):
    """Load (but do not persist) the requested features from a module
    (atlite data.py:27-73, same positional signature).  Returns
    {var: (dims, array)}."""
    mod = datamodules[module]
    if data_format is not None:
        params.setdefault("data_format", data_format)
    params.setdefault("monthly_requests", monthly_requests)
    params.setdefault("concurrent_requests", concurrent_requests)
    out = {}
    for feature in features:
        result = mod.get_data(cutout, feature, tmpdir=tmpdir,
                              **{**cutout.attrs, **params})
        for var, payload in result.items():
            if var in mod.features[feature]:
                out[var] = payload
    return out


def cutout_prepare(cutout, features=None, tmpdir=None, data_format=None,
                   overwrite=False, compression=None, show_progress=False,
                   dask_kwargs=None, monthly_requests=False,
                   concurrent_requests=False, **params):
    """Prepare a cutout (atlite data.py:133-274); delegates to
    Cutout.prepare, which implements the same resume semantics."""
    return cutout.prepare(features=features, tmpdir=tmpdir,
                          data_format=data_format, overwrite=overwrite,
                          compression=compression, show_progress=show_progress,
                          dask_kwargs=dask_kwargs,
                          monthly_requests=monthly_requests,
                          concurrent_requests=concurrent_requests, **params)
