"""Plain reference of the CF int16 packing that a streamed call's
uploads go through (ERA5's netCDF files store their fields the same
way, with ``scale_factor`` / ``add_offset``).

The rule, written from its statement, in float64:
- the offset is the variable's smallest value over the whole stored year,
  NaN left out, and the scale is (largest - smallest) / 65534 (1 where the
  two are equal; 0 and 1 for a variable that is NaN everywhere);
- a variable whose smallest value is positive and whose largest is more
  than 1e3 times it is packed in log space: offset and scale from the
  logarithms of the two, each value's logarithm coded;
- a value's code is rint((value - offset) / scale), clipped to 0..65534,
  and 65535 for NaN;
- a value is rebuilt as code * scale + offset, then exp in log space, and
  NaN from 65535.

Plain ``torch`` on the values' device, and ``numpy`` for the scalars'
logarithms (as a user's numpy computes them); it imports nothing of the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NAN_CODE = 65535
TOP = 65534  # the largest code of a value


def params(values):
    """(offset, scale, log_space) of a variable from all its stored
    values (a tensor of any shape)."""
    v = values.reshape(-1)
    v = v[~torch.isnan(v)]
    if v.numel() == 0:
        return 0.0, 1.0, False
    lo, hi = float(v.min()), float(v.max())
    if math.isinf(lo) or math.isinf(hi):
        raise ValueError("a variable with infinite values has no int16 packing")
    log_space = lo > 0.0 and hi / lo > 1e3
    if log_space:
        lo, hi = float(np.log(lo)), float(np.log(hi))
    return lo, ((hi - lo) / TOP if hi > lo else 1.0), log_space


def codes(values, p):
    """int32 codes 0..65535 of ``values`` packed with ``p`` = (offset,
    scale, log_space); the same shape."""
    offset, scale, log_space = p
    a = values.to(torch.float64)
    if log_space:
        a = torch.log(a)
    a = torch.round((a - offset) / scale).clamp(0.0, TOP)
    return torch.where(torch.isnan(a), NAN_CODE, a).to(torch.int32)


def rebuild(code, p):
    """float64 values of ``code`` packed with ``p``."""
    offset, scale, log_space = p
    v = code.to(torch.float64) * scale + offset
    v = torch.exp(v) if log_space else v
    return torch.where(code == NAN_CODE, math.nan, v)


def quantized(values, p=None):
    """``values`` as a packed upload rebuilds them: float64, packed with
    ``p`` (default: the values' own parameters)."""
    p = params(values) if p is None else p
    return rebuild(codes(values, p), p)
