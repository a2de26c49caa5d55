"""Spatial aggregation of cell series to bus series (counterpart of
``atlite_tpu/aggregate.py``).

Only the dense path is ported: matrices up to ``_DENSE_LIMIT`` entries.
Its NaN rule is the reference's sparse one: a NaN cell poisons only the
buses whose matrix row holds a nonzero entry at that cell.
"""

from __future__ import annotations

import contextlib

import scipy.sparse as sp
import torch

# the JAX package's limit between the dense and the banded path
_DENSE_LIMIT = 32 * 1024 * 1024


@contextlib.contextmanager
def _fp32_matmul():
    """Full float32 products: TF32 off for the duration of the block
    (it keeps ~3 decimal digits, far outside the parity tolerances)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


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
    with _fp32_matmul():
        out = torch.where(nan_mask, 0.0, flat_tc) @ dense_m.T
        touched = nan_mask.to(flat_tc.dtype) @ struct.T
    return torch.where(touched > 0, torch.nan, out)


def spmm_closure(matrix):
    """Pre-staged aggregation ``f(flat_tc) -> (T, B)`` for a host matrix.

    The dense copy and its structure indicator are staged on the field's
    device and dtype at the first call.  Matrices above ``_DENSE_LIMIT``
    entries take the banded path in the JAX package, which is not ported.
    """
    matrix = sp.csr_matrix(matrix)
    B, C = matrix.shape
    if B * C > _DENSE_LIMIT:
        raise NotImplementedError(
            f"a {B}x{C} matrix exceeds the dense limit ({_DENSE_LIMIT} "
            "entries); the banded path is not ported yet (ROADMAP queue 1, "
            "item 4)")
    state = {}

    def run(flat):
        key = (flat.device, flat.dtype)
        if state.get("key") != key:
            dense = matrix.toarray()
            state["key"] = key
            state["dense"] = torch.as_tensor(dense, dtype=flat.dtype,
                                             device=flat.device)
            state["struct"] = torch.as_tensor(dense != 0, dtype=flat.dtype,
                                              device=flat.device)
        return dense_spmm(flat, state["dense"], state["struct"])

    return run
