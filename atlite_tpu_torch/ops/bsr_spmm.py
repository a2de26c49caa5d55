"""Block-sparse and banded aggregation (counterpart of
``atlite_tpu/ops/bsr_spmm.py``).

Host builders, copied as numpy:
- ``to_bsr``: (B, C) sparse matrix -> sorted dense (block_b x block_c)
  blocks;
- ``_band_layout``/``banded_width``/``to_banded``: rows sorted by their
  column range and grouped into dense row-block bands.

Products, in PyTorch with TF32 off:
- ``bsr_spmm`` (whole-tile gather, ``torch.bmm``, ``index_add_`` over the
  row blocks) and ``bsr_spmm_scan`` (one block at a time): plain BSR;
- ``bsr_spmm_kernel``: the hand-written CUDA kernel ``csrc/bsr_spmm.cu``
  (port of ``bsr_spmm_pallas``: one product per nonzero entry, from the
  row-interleaved entries ``compact_bsr`` that ``stage_bsr`` adds) for
  tensors on a card, ``bsr_spmm`` for tensors on the CPU;
- ``stage_banded``/``banded_spmm``: the banded product, the production
  large-matrix path of ``aggregate.spmm_closure``.

Two NaN rules live here, each its JAX function's: the BSR products are
dense inside a block (a NaN field entry times a stored zero is NaN), the
banded product is sparse (a NaN cell poisons only the buses whose row
holds an entry there).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from atlite_tpu_torch.aggregate import fp32_matmul


def to_bsr(matrix: sp.spmatrix, block_b=32, block_c=512):
    """Convert a (B, C) sparse matrix to dense nonzero blocks.

    Returns dict with 'row_blk' (K,), 'col_blk' (K,) int32 and 'blocks'
    (K, block_b, block_c) in the matrix dtype, plus padded sizes.  Blocks
    are sorted by row then column, so each output row block owns one
    contiguous run of blocks.
    """
    B, C = matrix.shape
    nb = -(-B // block_b)
    nc = -(-C // block_c)
    coo = matrix.tocoo()
    rb = coo.row // block_b
    cb = coo.col // block_c
    keys = rb.astype(np.int64) * nc + cb
    uniq, inv = np.unique(keys, return_inverse=True)
    K = len(uniq)
    blocks = np.zeros((K, block_b, block_c), dtype=coo.data.dtype)
    blocks[inv, coo.row % block_b, coo.col % block_c] = coo.data
    row_blk = (uniq // nc).astype(np.int32)
    col_blk = (uniq % nc).astype(np.int32)
    order = np.lexsort((col_blk, row_blk))
    return {
        "row_blk": row_blk[order],
        "col_blk": col_blk[order],
        "blocks": blocks[order],
        "B": B, "C": C, "B_pad": nb * block_b, "C_pad": nc * block_c,
        "block_b": block_b, "block_c": block_c,
    }


SLAB = 512  # columns the kernel stages at once (csrc/bsr_spmm.cu kMaxWidth)
SUPER_ROWS = 64  # rows of the row blocks the kernel takes together


def compact_bsr(bsr):
    """The blocks of a to_bsr dict as the kernel reads them.

    G = max(1, SUPER_ROWS // bb) consecutive row blocks form a super row of
    R = G * bb rows; a unit is one column block of a super row, and its
    mask has bit h set where row block G * s + h stores a block there.  A
    unit's columns are cut into slabs of ``width = min(bc, SLAB)``, and the
    nonzero entries of (unit u, slab j), e = u * slabs + j, are
    row-interleaved (ELL) in slices of 32 rows, each as long as its longest
    row: with S = ceil(R / 32) and ``p = ell_ptr[e * S + r // 32]``, entry i
    of row r is ``ell[p + i * 32 + r % 32]``, an int32 pair of (column
    inside the slab, float32 bits of the weight), in column order, (0, 0)
    where the row has fewer entries.  Zero means ``blocks != 0`` in
    float32: stored zeros and -0.0 are zeros, a NaN weight is an entry, so
    no entry has the bits of 0.0.

    Super rows pay where consecutive row blocks share column blocks (the
    two halves of a region row in bus order iy * nx + ix): a unit's field
    tile is then staged once for both.  Where they share none, every unit
    holds one row block and a thread block's other rows idle.

    Returns a dict of numpy arrays ``ell``, ``ell_ptr``, ``unit_ptr``
    (nsr + 1,: super row s owns units [unit_ptr[s], unit_ptr[s + 1])),
    ``unit_col`` (the unit's column block), ``unit_mask`` (uint64) and the
    ints ``rows`` (R) and ``width``.
    """
    blocks = np.asarray(bsr["blocks"], dtype=np.float32)
    row_blk = np.asarray(bsr["row_blk"], dtype=np.int64)
    col_blk = np.asarray(bsr["col_blk"], dtype=np.int64)
    K, bb, bc = blocks.shape
    nb, nc = bsr["B_pad"] // bb, bsr["C_pad"] // bc
    if row_blk.size and (np.any(np.diff(row_blk) < 0) or row_blk[0] < 0 or row_blk[-1] >= nb
                         or col_blk.min() < 0 or col_blk.max() >= nc):
        raise ValueError("row_blk must be sorted and the blocks within the matrix (see to_bsr)")
    G = max(1, SUPER_ROWS // bb)
    R = G * bb
    nsr = -(-nb // G)
    # units: the column blocks of each super row, sorted
    units, unit_of = np.unique((row_blk // G) * nc + col_blk, return_inverse=True)
    unit_of = unit_of.reshape(-1)
    U = len(units)
    mask = np.zeros(U, dtype=np.uint64)
    np.bitwise_or.at(mask, unit_of, np.left_shift(np.uint64(1), (row_blk % G).astype(np.uint64)))
    width = min(bc, SLAB)
    slabs = -(-bc // width)
    # entries, by (unit, slab), row of the super row, then column
    k, r, c = np.nonzero(blocks)
    vals = blocks[k, r, c]
    step = unit_of[k] * slabs + c // width
    rr = (row_blk[k] % G) * bb + r
    order = np.lexsort((c, rr, step))
    step, rr, c, vals = step[order], rr[order], c[order], vals[order]
    S = -(-R // 32)
    group = step * S * 32 + rr  # (step, slice, row within the slice)
    rank = np.arange(len(group)) - np.searchsorted(group, group)  # i within its row
    per_row = np.bincount(group, minlength=U * slabs * S * 32).reshape(-1, 32)
    ptr = np.zeros(U * slabs * S + 1, dtype=np.int64)
    np.cumsum(per_row.max(axis=1) * 32, out=ptr[1:])
    if ptr[-1] > np.iinfo(np.int32).max:
        raise ValueError(f"{ptr[-1]} entry slots: the kernel counts them in int32")
    ell = np.zeros((ptr[-1], 2), dtype=np.int32)
    pos = ptr[group // 32] + rank * 32 + rr % 32
    ell[pos, 0] = c - (step % slabs) * width
    ell[pos, 1] = vals.view(np.int32)
    return {"ell": ell, "ell_ptr": ptr.astype(np.int32),
            "unit_ptr": np.searchsorted(units // nc, np.arange(nsr + 1)).astype(np.int32),
            "unit_col": (units % nc).astype(np.int32), "unit_mask": mask,
            "rows": R, "width": width}


def stage_bsr(bsr, device):
    """A to_bsr dict with its arrays as tensors on ``device`` (blocks in
    float32) and the form the kernel reads (``compact_bsr``, under the key
    ``compact``); the products then skip the upload."""
    device = torch.device(device)
    compact = {k: torch.as_tensor(v.view(np.int64) if k == "unit_mask" else v, device=device)
               if isinstance(v, np.ndarray) else v for k, v in compact_bsr(bsr).items()}
    return {**bsr,
            "row_blk": torch.as_tensor(bsr["row_blk"], device=device),
            "col_blk": torch.as_tensor(bsr["col_blk"], device=device),
            "blocks": torch.as_tensor(bsr["blocks"], dtype=torch.float32, device=device),
            "compact": compact}


def _bsr_operands(bsr, flat_tc):
    """(row_blk, col_blk, blocks) as tensors on the field's device, the
    indices as int64, the blocks in the field's dtype."""
    dev = flat_tc.device
    return (torch.as_tensor(bsr["row_blk"], device=dev).long(),
            torch.as_tensor(bsr["col_blk"], device=dev).long(),
            torch.as_tensor(bsr["blocks"], dtype=flat_tc.dtype, device=dev))


def bsr_spmm(bsr, flat_tc):
    """Aggregate (T, C) -> (T, B) with a BSR matrix (see to_bsr): gather
    whole (block_c, T) field tiles, one batched product, and a sum over
    each row block's products."""
    T, C = flat_tc.shape
    bb, bc = bsr["block_b"], bsr["block_c"]
    row_blk, col_blk, blocks = _bsr_operands(bsr, flat_tc)
    tiles = F.pad(flat_tc.T, (0, 0, 0, (-C) % bc)).reshape(-1, bc, T)
    with fp32_matmul():
        part = torch.bmm(blocks, tiles[col_blk])  # (K, bb, T)
    out = flat_tc.new_zeros((bsr["B_pad"] // bb, bb, T)).index_add_(0, row_blk, part)
    return out.reshape(-1, T)[: bsr["B"]].T


def bsr_spmm_scan(bsr, flat_tc):
    """One block at a time (lowest memory)."""
    T, C = flat_tc.shape
    bb, bc = bsr["block_b"], bsr["block_c"]
    row_blk, col_blk, blocks = _bsr_operands(bsr, flat_tc)
    flat_ct = F.pad(flat_tc.T, (0, 0, 0, bsr["C_pad"] - C))
    out = flat_tc.new_zeros((bsr["B_pad"], T))
    with fp32_matmul():
        for rb, cb, blk in zip(row_blk.tolist(), col_blk.tolist(), blocks):
            out[rb * bb:(rb + 1) * bb] += blk @ flat_ct[cb * bc:(cb + 1) * bc]
    return out[: bsr["B"]].T


# ---------------------------------------------------------------------------
# The CUDA kernel (port of bsr_spmm_pallas)
# ---------------------------------------------------------------------------
@functools.cache
def _library():
    """The built kernel library, its C signatures declared."""
    from atlite_tpu_torch.ops import _build

    lib = _build.library("bsr_spmm")
    lib.bsr_spmm_launch.restype = ctypes.c_int
    lib.bsr_spmm_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                    + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.bsr_spmm_error_string.restype = ctypes.c_char_p
    lib.bsr_spmm_error_string.argtypes = [ctypes.c_int]
    lib.bsr_spmm_occupancy.restype = ctypes.c_int
    lib.bsr_spmm_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_int)]
    return lib


def _raise_on(rc, what):
    if rc != 0:
        msg = _library().bsr_spmm_error_string(rc).decode()
        raise RuntimeError(f"bsr_spmm_kernel {what} failed: CUDA error {rc} ({msg})")


def occupancy(device_index, width):
    """(resident blocks an SM, shared-memory bytes a block) of the kernel
    at slab width ``width`` on card ``device_index``."""
    per_sm, smem = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(_library().bsr_spmm_occupancy(device_index, width, ctypes.byref(per_sm),
                                            ctypes.byref(smem)), "occupancy query")
    return per_sm.value, smem.value


def bsr_spmm_kernel(bsr, flat_tc):
    """Aggregate (T, C) -> (T, B) with a BSR matrix (see to_bsr).

    ``bsr`` may come from ``stage_bsr``.  A float32 field on a CUDA card
    goes through ``csrc/bsr_spmm.cu`` (``launches`` counts the launches);
    a field on the CPU through the plain ``bsr_spmm``.  Both follow
    ``bsr_spmm_pallas``: the sum of the products at the stored entries,
    where a non-finite field value times a stored zero is NaN (the kernel
    multiplies only the nonzero entries and applies that rule exactly),
    zeros for buses that no block covers.
    """
    if not isinstance(flat_tc, torch.Tensor) or flat_tc.ndim != 2:
        raise TypeError("flat_tc must be a (T, C) torch.Tensor")
    T, C = flat_tc.shape
    if C != bsr["C"]:
        raise ValueError(f"field has {C} cells, the matrix {bsr['C']}")
    if flat_tc.device.type == "cpu":
        return bsr_spmm(bsr, flat_tc)
    if flat_tc.device.type != "cuda":
        raise ValueError(f"tensors must lie on the CPU or a CUDA card, not {flat_tc.device}")
    if flat_tc.dtype != torch.float32 or not flat_tc.is_contiguous():
        raise TypeError("the kernel takes a contiguous float32 field")
    if T < 1 or C < 1:
        raise ValueError(f"empty field {(T, C)}")
    bb, bc, B = bsr["block_b"], bsr["block_c"], bsr["B"]
    dev = flat_tc.device
    if "compact" not in bsr:
        bsr = stage_bsr(bsr, dev)
    cp = bsr["compact"]
    arrays = [cp[k] for k in ("ell", "ell_ptr", "unit_ptr", "unit_col", "unit_mask")]
    if any(t.device != dev for t in arrays):
        raise ValueError(f"the staged matrix is not on {dev}, where the field is")
    if not all(t.is_contiguous() for t in arrays) or [t.dtype for t in arrays] != [
            torch.int32] * 4 + [torch.int64]:
        raise TypeError("the kernel takes the compact form of stage_bsr")
    out = torch.empty((T, B), dtype=torch.float32, device=dev)
    lib = _library()
    rc = lib.bsr_spmm_launch(
        dev.index, flat_tc.data_ptr(), *(t.data_ptr() for t in arrays), out.data_ptr(),
        T, C, B, bb, bc, cp["rows"], cp["width"], cp["unit_ptr"].numel() - 1,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "launch")
    bsr_spmm_kernel.launches += 1
    return out


bsr_spmm_kernel.launches = 0


# ---------------------------------------------------------------------------
# Banded formulation — the production large-matrix path
# ---------------------------------------------------------------------------
def _band_layout(csr, block_b, align):
    """Banding geometry shared by banded_width and to_banded: per-row
    column ranges, the row sort, and per-block aligned [start, end)
    windows."""
    B = csr.shape[0]
    nb = -(-B // block_b)
    c0 = np.zeros(B, dtype=np.int64)
    c1 = np.ones(B, dtype=np.int64)
    for r in range(B):
        cols = csr.indices[csr.indptr[r]:csr.indptr[r + 1]]
        if len(cols):
            c0[r], c1[r] = cols.min(), cols.max() + 1
    order = np.argsort(c0, kind="stable")
    starts = np.zeros(nb, dtype=np.int64)
    ends = np.zeros(nb, dtype=np.int64)
    for b in range(nb):
        rows = order[b * block_b:(b + 1) * block_b]
        starts[b] = (c0[rows].min() // align) * align
        ends[b] = -(-c1[rows].max() // align) * align
    return nb, order, starts, ends


def banded_width(matrix: sp.spmatrix, block_b=128, align=512):
    """(nb, W) of the banded representation, without building the bands
    (an O(nnz) probe for routing)."""
    nb, _, starts, ends = _band_layout(matrix.tocsr(), block_b, align)
    return nb, int((ends - starts).max())


def to_banded(matrix: sp.spmatrix, block_b=128, align=512, force_w=None):
    """Convert a (B, C) sparse matrix to sorted dense row-block bands:
    'bands' (nb, block_b, W) in the matrix dtype, 'tile_idx' (nb, W/align)
    int32 field-tile indices, and the 'order'/'inverse' row permutations.
    """
    B, C = matrix.shape
    csr = matrix.tocsr()
    nb, order, starts, ends = _band_layout(csr, block_b, align)
    inverse = np.argsort(order)
    W = int((ends - starts).max())
    if force_w is not None:
        if force_w % align or force_w < W:
            raise ValueError(f"force_w={force_w} must be a multiple of {align} "
                             f"and at least {W}")
        W = force_w
    n_tiles = W // align

    bands = np.zeros((nb, block_b, W), dtype=csr.dtype)
    coo = csr.tocoo()
    rpos = inverse[coo.row]  # position in sorted order
    blk = rpos // block_b
    bands[blk, rpos % block_b, coo.col - starts[blk]] = coo.data

    C_pad = -(-max(C, int(ends.max())) // align) * align
    tile_idx = (starts[:, None] // align
                + np.arange(n_tiles)[None, :]).astype(np.int32)
    return {
        "bands": bands, "tile_idx": tile_idx,
        "order": order, "inverse": inverse,
        "B": B, "C": C, "C_pad": int(C_pad), "W": W,
        "block_b": block_b, "align": align, "nb": nb,
    }


def _banded_spmm(flat_tc, bands, tile_idx, inverse, align, c_pad):
    T = flat_tc.shape[0]
    nb, bb, W = bands.shape
    fb = F.pad(flat_tc.T, (0, 0, 0, c_pad - flat_tc.shape[1]))
    g = fb.reshape(-1, align, T)[tile_idx].reshape(nb, W, T)  # whole-tile gather
    with fp32_matmul():
        out = torch.bmm(bands, g)
    return out.reshape(nb * bb, T)[inverse]  # back to caller row order


def stage_banded(banded, dtype, device):
    """The (bands, tile_idx, inverse) tensors banded_spmm consumes, on a
    device, the bands in ``dtype``."""
    bands = torch.as_tensor(banded["bands"], dtype=dtype, device=device)
    # a band narrower than W reaches past C_pad: clamp to the last tile
    # (as XLA's gather does), where it meets zero band entries
    tidx = np.minimum(banded["tile_idx"].astype(np.int64), banded["C_pad"] // banded["align"] - 1)
    tidx = torch.as_tensor(tidx, device=device)
    inv = np.pad(banded["inverse"], (0, banded["nb"] * banded["block_b"] - banded["B"]),
                 constant_values=banded["nb"] * banded["block_b"] - 1)
    return bands, tidx, torch.as_tensor(inv.astype(np.int64), device=device)


def banded_spmm(banded, flat_tc, staged=None):
    """Aggregate (T, C) -> (T, B) with a banded matrix (see to_banded).

    Sparse NaN rule: NaN cells are zeroed for the product, and an
    indicator product against the band structure marks the buses whose
    rows hold an entry at a NaN cell.  The indicator runs only when the
    field holds a NaN.  ``staged`` takes a stage_banded() triple.
    """
    if staged is None:
        staged = stage_banded(banded, flat_tc.dtype, flat_tc.device)
    bands, tidx, inv = staged
    kw = dict(align=banded["align"], c_pad=banded["C_pad"])
    nan_mask = torch.isnan(flat_tc)
    if bool(nan_mask.any()):
        out = _banded_spmm(torch.where(nan_mask, 0.0, flat_tc), bands, tidx, inv, **kw)
        touched = _banded_spmm(nan_mask.to(flat_tc.dtype), (bands != 0).to(flat_tc.dtype),
                               tidx, inv, **kw)
        out = torch.where(touched > 0, torch.nan, out)
    else:
        out = _banded_spmm(flat_tc, bands, tidx, inv, **kw)
    return out[: banded["B"]].T
