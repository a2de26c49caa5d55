"""Spatial aggregation of cell series to bus series (counterpart of
``atlite_tpu/aggregate.py``).

The contraction routes by matrix structure, as in the JAX package:
- a dense float32 product up to ``_DENSE_LIMIT`` entries;
- the banded formulation (``ops/bsr_spmm.to_banded``) for large matrices
  whose rows span narrow column ranges;
- a dense product over row chunks when no band structure exists.
Every route keeps the reference's sparse NaN rule: a NaN cell poisons only
the buses whose matrix row holds a nonzero entry at that cell.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from atlite_tpu_torch.core.device import fp32_matmul
from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.ops import bsr_spmm
from atlite_tpu_torch.profiling import span

# the JAX package's limit between the dense and the banded path; read at
# call time
_DENSE_LIMIT = 32 * 1024 * 1024


def spdiag(v):
    """Sparse diagonal matrix (reference gis.py:78-84)."""
    return sp.diags(np.asarray(v).ravel()).tocsr()


def dense_spmm(flat_tc, dense_m, struct=None):
    """(T, C) cell series times the (B, C) matrix, transposed: (T, B).

    NaN cells are zeroed for the product, and an indicator product against
    the structure (``dense_m != 0``, or ``struct`` when given) marks the
    buses they touch as NaN — stored zeros count as structural zeros.
    Both products run in float32 with TF32 off.
    """
    nan_mask = torch.isnan(flat_tc)
    if struct is None:
        struct = (dense_m != 0).to(flat_tc.dtype)
    with fp32_matmul():
        out = torch.where(nan_mask, 0.0, flat_tc) @ dense_m.T
        touched = nan_mask.to(flat_tc.dtype) @ struct.T
    return torch.where(touched > 0, torch.nan, out)


def spmm(matrix, flat_tc):
    """Aggregate (T, C) cell series to (T, B) bus series with a host sparse
    matrix; a one-shot call stages unbanded row chunks one at a time."""
    return spmm_closure(matrix, resident=False)(flat_tc)


def spmm_closure(matrix, resident=True):
    """Pre-staged aggregation ``f(flat_tc) -> (T, B)`` for a host matrix.

    The matrix (dense, banded, or dense row chunks) is staged on the
    field's device and dtype at the first call and kept there, so a
    streamed conversion moves only the (T_chunk, B) series back.
    ``resident=False`` stages each dense row chunk of an unbanded large
    matrix for one product and releases it.  Each staging runs in a
    ``copy`` span of the enclosing call's hours.
    """
    matrix = sp.csr_matrix(matrix)
    B, C = matrix.shape
    state = {}

    def staged(flat, make):
        key = (flat.device, flat.dtype)
        if state.get("key") != key:
            with span("copy"):
                state["key"], state["value"] = key, make(flat)
        return state["value"]

    if B * C <= _DENSE_LIMIT:
        def dense(flat):
            d = matrix.toarray()
            return (torch.as_tensor(d, dtype=flat.dtype, device=flat.device),
                    torch.as_tensor(d != 0, dtype=flat.dtype, device=flat.device))

        def run(flat):
            return dense_spmm(flat, *staged(flat, dense))

        return run

    nb, W = bsr_spmm.banded_width(matrix)
    if nb * 128 * W <= (B * C) // 2:
        banded = bsr_spmm.to_banded(matrix, force_w=W or None)

        def run_banded(flat):
            stage = staged(flat, lambda f: bsr_spmm.stage_banded(banded, f.dtype, f.device))
            return bsr_spmm.banded_spmm(banded, flat, stage)

        return run_banded

    row_chunk = max(1, _DENSE_LIMIT // C)

    def chunk(flat, b0):
        with span("copy"):
            return torch.as_tensor(matrix[b0:b0 + row_chunk].toarray(), dtype=flat.dtype,
                                   device=flat.device)

    def run_chunked(flat):
        starts = range(0, B, row_chunk)
        if resident:
            blocks = staged(flat, lambda f: [chunk(f, b0) for b0 in starts])
            return torch.cat([dense_spmm(flat, blk) for blk in blocks], dim=1)
        # one row chunk alive at a time
        return torch.cat([dense_spmm(flat, chunk(flat, b0)) for b0 in starts], dim=1)

    return run_chunked


def aggregate_matrix(da, matrix, index=None, index_name="bus"):
    """Aggregate a (time, y, x) DataArray to (bus, time) with a sparse
    bus-x-cell matrix whose C = Y*X columns run row-major over (y, x)."""
    matrix = sp.csr_matrix(matrix)
    T = da.sizes["time"]
    out = spmm(matrix, torch.as_tensor(da.values).reshape(T, -1))  # (T, B)
    if index is None:
        index = np.arange(matrix.shape[0])
    name = getattr(index, "name", None) or index_name
    return DataArray(
        out.T.cpu().numpy(),
        coords={name: index, "time": da.coords["time"]},
        dims=(name, "time"),
        attrs=da.attrs,
        name=da.name,
    )
