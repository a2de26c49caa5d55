"""The port's block-sparse and banded aggregation against the JAX
package's ``atlite_tpu/ops/bsr_spmm.py``.

The host builders must give equal arrays.  The products (the port's
``bsr_spmm``, ``bsr_spmm_scan``, ``bsr_spmm_kernel`` on the CPU, i.e. its
plain route, and ``banded_spmm``) are held against JAX's ``bsr_spmm``,
``bsr_spmm_pallas`` (interpret mode, patched as ``tests/test_bsr.py``
patches it) and ``banded_spmm``, with x64 off.

Tolerance: float32 sums of up to a few thousand products of order 1 in
another order: rtol 1e-5, atol 2e-5.  NaN masks must be identical: the BSR
products follow the dense-in-block rule (a NaN entry times a stored zero
is NaN), the banded one the sparse rule.
"""

import unittest.mock as mock

import jax
import jax.experimental.pallas as pl
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from atlite_tpu.ops import bsr_spmm as jbs
from atlite_tpu_torch.ops import bsr_spmm as tbs

torch.set_num_threads(1)


ORIG_PALLAS_CALL = pl.pallas_call


def interp(*a, **k):
    k.setdefault("interpret", True)
    return ORIG_PALLAS_CALL(*a, **k)


def assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def random_case(nan_cells=0):
    """The 37 x 3000 x 100 case of tests/test_bsr.py, with NaN cells."""
    rng = np.random.default_rng(0)
    m = sp.random(37, 3000, density=0.02, random_state=1, format="csr")
    flat = rng.random((100, 3000)).astype(np.float32)
    flat[rng.integers(0, 100, nan_cells), rng.integers(0, 3000, nan_cells)] = np.nan
    return m, flat


def empty_row_block_case():
    """tests/test_bsr.py:151: rows 4..7 (the second 4-row block) empty."""
    B, C, T = 8, 32, 6
    rng = np.random.default_rng(3)
    m = sp.csr_matrix((rng.random(16), (np.repeat(np.arange(4), 4),
                                        rng.choice(C, 16, replace=False))), shape=(B, C))
    return m, rng.random((T, C)).astype(np.float32)


CASES = {
    "8x256": (random_case, 8, 256),
    "8x512": (random_case, 8, 512),
    "32x512": (random_case, 32, 512),
    "empty-row-block-4x8": (empty_row_block_case, 4, 8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_to_bsr_equals_jax(name):
    make, bb, bc = CASES[name]
    m, _ = make()
    got, want = tbs.to_bsr(m, bb, bc), jbs.to_bsr(m, bb, bc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("nan_cells", [0, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bsr_products_match_jax(name, nan_cells):
    make, bb, bc = CASES[name]
    m, flat = make() if make is empty_row_block_case else make(nan_cells)
    if make is empty_row_block_case and nan_cells:
        flat[2, 5] = np.nan
    bsr = jbs.to_bsr(m, bb, bc)
    with jax.enable_x64(False):
        want = np.asarray(jbs.bsr_spmm(bsr, flat))
        with mock.patch.object(pl, "pallas_call", interp):
            want_pallas = np.asarray(jbs.bsr_spmm_pallas(bsr, flat, time_tile=8))
    assert_same(want_pallas, want)
    f = torch.as_tensor(flat)
    for fn in (tbs.bsr_spmm, tbs.bsr_spmm_scan, tbs.bsr_spmm_kernel):
        assert_same(fn(tbs.to_bsr(m, bb, bc), f).numpy(), want)
    if make is empty_row_block_case:
        assert np.all(tbs.bsr_spmm_kernel(bsr, f).numpy()[:, 4:] == 0.0)


def test_bsr_dense_in_block_nan_rule():
    """A NaN cell poisons every bus of a row block that stores a block over
    it, zero entries included, as the Pallas kernel's dense dot does."""
    m = sp.csr_matrix(([1.0], ([0], [3])), shape=(4, 16))
    flat = np.ones((2, 16), dtype=np.float32)
    flat[1, 5] = np.nan  # inside the stored block, at a zero entry
    got = tbs.bsr_spmm_kernel(tbs.to_bsr(m, 4, 8), torch.as_tensor(flat)).numpy()
    assert np.isnan(got[1]).all() and not np.isnan(got[0]).any()


def test_bsr_kernel_wrapper_counts_only_launches():
    m, flat = random_case()
    before = tbs.bsr_spmm_kernel.launches
    tbs.bsr_spmm_kernel(tbs.to_bsr(m), torch.as_tensor(flat))
    assert tbs.bsr_spmm_kernel.launches == before  # CPU: the plain route
    with pytest.raises(ValueError, match="cells"):
        tbs.bsr_spmm_kernel(tbs.to_bsr(m), torch.as_tensor(flat[:, :10]))


def test_stage_bsr_row_pointer():
    """The pointer over the units: super row s (G = 8 row blocks of 8 rows)
    owns the units of its row blocks' column blocks, in column order."""
    m, flat = random_case()
    bsr = tbs.to_bsr(m, 8, 256)
    staged = tbs.stage_bsr(bsr, "cpu")
    ptr, cols = staged["compact"]["unit_ptr"].numpy(), staged["compact"]["unit_col"].numpy()
    nsr = -(-(bsr["B_pad"] // 8) // 8)
    assert ptr[0] == 0 and ptr[-1] == len(cols) and len(ptr) == nsr + 1
    for s in range(nsr):
        want = np.unique(bsr["col_blk"][bsr["row_blk"] // 8 == s])
        np.testing.assert_array_equal(cols[ptr[s]:ptr[s + 1]], want)
    assert_same(tbs.bsr_spmm(staged, torch.as_tensor(flat)).numpy(),
                tbs.bsr_spmm(bsr, torch.as_tensor(flat)).numpy())
    unsorted = dict(bsr, row_blk=bsr["row_blk"][::-1].copy())
    with pytest.raises(ValueError, match="sorted"):
        tbs.stage_bsr(unsorted, "cpu")


def local_matrix(B=40, Y=32, X=48, seed=3):
    """tests/test_bsr.py:60: 5x5-cell regions at random places."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for b in range(B):
        y0, x0 = rng.integers(0, Y - 5), rng.integers(0, X - 5)
        cc = (np.arange(y0, y0 + 5)[:, None] * X + np.arange(x0, x0 + 5)[None, :]).ravel()
        rows += [b] * len(cc)
        cols += list(cc)
        vals += list(rng.random(len(cc)))
    return sp.csr_matrix((vals, (rows, cols)), shape=(B, Y * X))


def empty_rows_matrix():
    """tests/test_bsr.py:83: out-of-order band starts and empty rows."""
    m = sp.lil_matrix((5, 1000))
    m[0, 900] = 3.0
    m[2, 5] = 2.0
    return m.tocsr()


BANDED = {
    "random-16x256": (lambda: random_case()[0], 16, 256, None),
    "random-2x128": (lambda: random_case()[0], 2, 128, None),
    "local-8x128": (local_matrix, 8, 128, None),
    "local-8x128-forced": (local_matrix, 8, 128, 1536),
    "empty-rows-2x128": (empty_rows_matrix, 2, 128, None),
}


@pytest.mark.parametrize("name", sorted(BANDED))
def test_band_builders_equal_jax(name):
    make, bb, align, force_w = BANDED[name]
    m = make()
    for g, w in zip(tbs._band_layout(m.tocsr(), bb, align), jbs._band_layout(m.tocsr(), bb, align)):
        np.testing.assert_array_equal(g, w)
    assert tbs.banded_width(m, bb, align) == jbs.banded_width(m, bb, align)
    got = tbs.to_banded(m, bb, align, force_w=force_w)
    want = jbs.to_banded(m, bb, align, force_w=force_w)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("nan_cells", [0, 5])
@pytest.mark.parametrize("name", sorted(BANDED))
def test_banded_spmm_matches_jax(name, nan_cells):
    make, bb, align, force_w = BANDED[name]
    m = make()
    rng = np.random.default_rng(7)
    T, C = 17, m.shape[1]
    flat = rng.random((T, C)).astype(np.float32)
    flat[rng.integers(0, T, nan_cells), rng.integers(0, C, nan_cells)] = np.nan
    if nan_cells:
        flat[:, m.indices[0]] = np.nan  # a cell of the first stored entry, at every hour
    with jax.enable_x64(False):
        want = np.asarray(jbs.banded_spmm(jbs.to_banded(m, bb, align, force_w=force_w), flat))
    banded = tbs.to_banded(m, bb, align, force_w=force_w)
    got = tbs.banded_spmm(banded, torch.as_tensor(flat)).numpy()
    assert_same(got, want)
    staged = tbs.stage_banded(banded, torch.float32, "cpu")
    assert_same(tbs.banded_spmm(banded, torch.as_tensor(flat), staged=staged).numpy(), want)
    if nan_cells:
        assert np.isnan(got).any() and not np.isnan(got).all()  # the sparse rule


def test_banded_empty_rows_are_zero():
    banded = tbs.to_banded(empty_rows_matrix(), block_b=2, align=128)
    out = tbs.banded_spmm(banded, torch.ones((10, 1000))).numpy()
    np.testing.assert_array_equal(out[:, 1], 0.0)
    np.testing.assert_array_equal(out[:, 3:], 0.0)
    np.testing.assert_allclose(out[:, 0], 3.0)
    np.testing.assert_allclose(out[:, 2], 2.0)


# ---------------------------------------------------------------------------
# The form the CUDA kernel reads (compact_bsr) and its rule, emulated
# ---------------------------------------------------------------------------
def weights_case():
    """Explicit stored zeros, -0.0 and NaN weights, and a row block whose
    only stored values are zeros."""
    rows = [0, 0, 1, 2, 3, 5, 6, 9, 9]
    cols = [1, 7, 7, 3, 12, 0, 9, 2, 14]
    vals = [0.0, 2.0, -0.0, np.nan, 1.5, 0.0, -3.0, -0.0, 0.0]
    return sp.csr_matrix((np.array(vals, dtype=np.float32), (rows, cols)), shape=(11, 16))


def unit_slots(cp, e):
    """The ELL slots of (unit, slab) e as (slot, row of the super row, 2),
    its 32-row slices side by side, padded to the longest."""
    S = -(-cp["rows"] // 32)
    ptr = cp["ell_ptr"][e * S:(e + 1) * S + 1]
    n = max(int(b - a) // 32 for a, b in zip(ptr[:-1], ptr[1:]))
    out = np.zeros((n, S * 32, 2), dtype=np.int32)
    for q in range(S):
        part = cp["ell"][ptr[q]:ptr[q + 1]].reshape(-1, 32, 2)
        out[:len(part), q * 32:(q + 1) * 32] = part
    return out


def rebuild_blocks(bsr, cp):
    """The (K, bb, bc) float32 blocks that a compact_bsr form stands for;
    checks the units' masks and the ELL layout on the way."""
    bb, bc = bsr["block_b"], bsr["block_c"]
    R, width = cp["rows"], cp["width"]
    G, slabs = R // bb, -(-bc // width)
    index = {(int(r), int(c)): k for k, (r, c) in enumerate(zip(bsr["row_blk"], bsr["col_blk"]))}
    blocks = np.zeros((len(index), bb, bc), dtype=np.float32)
    for s in range(len(cp["unit_ptr"]) - 1):
        for u in range(cp["unit_ptr"][s], cp["unit_ptr"][s + 1]):
            cb = int(cp["unit_col"][u])
            stored = [h for h in range(G) if (s * G + h, cb) in index]
            assert int(cp["unit_mask"][u]) == sum(1 << h for h in stored)
            for j in range(slabs):
                slots = unit_slots(cp, u * slabs + j)
                assert not slots[:, R:].any()  # the rows past R of the last slice
                for rr in range(R):
                    live = slots[:, rr, 1] != 0
                    n = int(live.sum())
                    assert live[:n].all() and not slots[n:, rr].any()  # padding (0, 0) last
                    col = slots[:n, rr, 0]
                    assert np.all(np.diff(col) > 0) and np.all((0 <= col) & (col < width))
                    if n:
                        k = index[(s * G + rr // bb, cb)]
                        blocks[k, rr % bb, j * width + col] = slots[:n, rr, 1].view(np.float32)
    return blocks


COMPACT_CASES = {**{name: (lambda make=make: make()[0], bb, bc)
                    for name, (make, bb, bc) in CASES.items()},
                 "weights-4x8": (weights_case, 4, 8), "weights-2x4": (weights_case, 2, 4),
                 "slabs-8x1300": (lambda: sp.random(40, 3001, density=0.05, random_state=2,
                                                    format="csr"), 8, 1300)}


@pytest.mark.parametrize("name", sorted(COMPACT_CASES))
def test_compact_form_rebuilds_blocks(name):
    make, bb, bc = COMPACT_CASES[name]
    bsr = tbs.to_bsr(make(), bb, bc)
    cp = tbs.compact_bsr(bsr)
    blocks = np.asarray(bsr["blocks"], dtype=np.float32)
    np.testing.assert_array_equal(rebuild_blocks(bsr, cp), blocks)  # -0.0 == 0.0, NaN == NaN
    assert int((cp["ell"][:, 1] != 0).sum()) == int(np.count_nonzero(blocks))
    staged = tbs.stage_bsr(bsr, "cpu")["compact"]
    for k in ("ell", "ell_ptr", "unit_ptr", "unit_col"):
        np.testing.assert_array_equal(staged[k].numpy(), cp[k])
    np.testing.assert_array_equal(staged["unit_mask"].numpy().view(np.uint64), cp["unit_mask"])


def test_compact_form_weights():
    """Stored zeros and -0.0 are not entries, a NaN weight is; the row block
    whose stored values are all zeros keeps its block (mask bit) and no
    entry."""
    bsr = tbs.to_bsr(weights_case(), 4, 8)
    cp = tbs.compact_bsr(bsr)
    vals = cp["ell"][cp["ell"][:, 1] != 0, 1].view(np.float32)
    assert len(vals) == 4 and np.isnan(vals).sum() == 1 and not (vals == 0).any()
    assert cp["rows"] == 64 and len(cp["unit_ptr"]) == 2
    masks = {int(c): int(m) for c, m in zip(cp["unit_col"], cp["unit_mask"])}
    assert masks == {0: 0b111, 1: 0b111}
    for e in range(len(cp["unit_col"])):  # one slab a unit
        assert not unit_slots(cp, e)[:, 8:12].any()  # row block 2 stores only zeros


def emulate_kernel(bsr, flat):
    """The CUDA kernel's rule on the CPU, from compact_bsr, in float32: one
    product per nonzero entry, then, per (unit, slab) whose row block stores
    a block, NaN where the hour's non-finite field values in the slab's
    columns (n_t) outnumber those met at the row's nonzeros (m)."""
    cp = tbs.compact_bsr(bsr)
    T, C = flat.shape
    bb, bc, R, width = bsr["block_b"], bsr["block_c"], cp["rows"], cp["width"]
    slabs = -(-bc // width)
    f = np.zeros((T, bsr["C_pad"]), dtype=np.float32)
    f[:, :C] = flat
    nsr = len(cp["unit_ptr"]) - 1
    out = np.zeros((T, nsr * R), dtype=np.float32)
    for s in range(nsr):
        for u in range(cp["unit_ptr"][s], cp["unit_ptr"][s + 1]):
            for j in range(slabs):
                c0 = int(cp["unit_col"][u]) * bc + j * width
                tile = f[:, c0:c0 + min(width, bc - j * width)]
                bad = ~np.isfinite(tile)
                slots = unit_slots(cp, u * slabs + j)
                for rr in range(R):
                    live = slots[:, rr, 1] != 0
                    cols, w = slots[live, rr, 0], slots[live, rr, 1].view(np.float32)
                    acc = out[:, s * R + rr]
                    for c, wc in zip(cols, w):
                        acc = acc + wc * tile[:, c]
                    if (int(cp["unit_mask"][u]) >> (rr // bb)) & 1:
                        acc = np.where(bad.sum(1) > bad[:, cols].sum(1), np.float32(np.nan), acc)
                    out[:, s * R + rr] = acc
    return out[:, :bsr["B"]]


def inf_only_case():
    """A row whose only entries at a +-Inf cell are nonzero (+-Inf, not
    NaN), rows with a stored zero there (NaN), +Inf meeting a negative
    weight (-Inf)."""
    m = sp.lil_matrix((8, 40), dtype=np.float32)
    m[0, 0:8] = 1.0
    m[1, 3] = 2.0
    m[2, 5] = -1.0
    m[5, 12] = 1.0
    flat = np.ones((3, 40), dtype=np.float32)
    flat[0, 3], flat[1, 3], flat[2, 5] = np.inf, -np.inf, np.inf
    return m.tocsr(), flat


def nonfinite_case(values, bb=8, bc=256, seed=0):
    m, flat = random_case()
    rng = np.random.default_rng(seed)
    for v in values:
        flat[rng.integers(0, flat.shape[0], 4), rng.integers(0, flat.shape[1], 4)] = v
    flat[:, m.indices[0]] = values[0]  # a cell of the first stored entry, at every hour
    return m, flat, bb, bc


def region_case(values, seed=1):
    """chip_smoke's region matrix on a 13 x 23 grid: one nonzero a column,
    4 x 8 regions, two row blocks of 16 per region row."""
    iy = np.minimum(np.arange(13) * 4 // 13, 3)
    ix = np.minimum(np.arange(23) * 8 // 23, 7)
    bus = (iy[:, None] * 8 + ix[None, :]).ravel()
    C = bus.size
    m = sp.csr_matrix((np.ones(C, dtype=np.float32), (bus, np.arange(C))), shape=(32, C))
    rng = np.random.default_rng(seed)
    flat = rng.random((9, C), dtype=np.float32)
    for v in values:
        flat[rng.integers(0, 9, 3), rng.integers(0, C, 3)] = v
    return m, flat, 4, 64


def weights_nonfinite_case():
    flat = np.ones((5, 16), dtype=np.float32)
    flat[0, 7], flat[1, 3], flat[2, 12], flat[3, 1] = np.inf, -np.inf, np.nan, np.inf
    return weights_case(), flat, 4, 8


NONFINITE = {
    "weights": weights_nonfinite_case,
    "nan": lambda: nonfinite_case([np.nan]),
    "+inf": lambda: nonfinite_case([np.inf]),
    "-inf": lambda: nonfinite_case([-np.inf]),
    "mixed-32x512": lambda: nonfinite_case([np.inf, -np.inf, np.nan], 32, 512, seed=1),
    "inf-only-at-nonzeros": lambda: (*inf_only_case(), 4, 8),
    "regions": lambda: region_case([np.inf, -np.inf, np.nan]),
}


@pytest.mark.parametrize("name", sorted(NONFINITE))
def test_kernel_rule_matches_jax(name):
    m, flat, bb, bc = NONFINITE[name]()
    bsr = jbs.to_bsr(m, bb, bc)
    with jax.enable_x64(False):
        want = np.asarray(jbs.bsr_spmm(bsr, flat))
        with mock.patch.object(pl, "pallas_call", interp):
            want_pallas = np.asarray(jbs.bsr_spmm_pallas(bsr, flat, time_tile=8))
    got = emulate_kernel(tbs.to_bsr(m, bb, bc), flat)
    assert np.isinf(want).any() or name == "nan"
    assert_same(got, want)
    assert_same(got, want_pallas)
    if name == "inf-only-at-nonzeros":
        inf, nan = np.inf, np.nan
        assert_same(got[:, :4], [[inf, inf, nan, nan], [-inf, -inf, nan, nan], [inf, nan, -inf, nan]])


@pytest.mark.parametrize("name", sorted(NONFINITE))
def test_plain_bsr_matches_jax_on_nonfinite_cells(name):
    m, flat, bb, bc = NONFINITE[name]()
    with jax.enable_x64(False):
        want = np.asarray(jbs.bsr_spmm(jbs.to_bsr(m, bb, bc), flat))
    f = torch.as_tensor(flat)
    for fn in (tbs.bsr_spmm, tbs.bsr_spmm_scan, tbs.bsr_spmm_kernel):
        assert_same(fn(tbs.to_bsr(m, bb, bc), f).numpy(), want)
