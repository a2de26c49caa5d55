"""The BSR CUDA kernel (port of ``bsr_spmm_pallas``) against its plain
PyTorch version, on a card.

The kernel has no CPU mode, so these tests skip without a CUDA card.  They
import neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_bsr_cuda.py

Tolerance: max abs diff within 1e-5 * max|plain| (float32 sums over a
block row in another order than cuBLAS and index_add_), NaN masks and +-Inf
positions identical (the dense-in-block rule: a non-finite entry times a
stored zero is NaN; the kernel multiplies only the nonzero entries and
counts the rest), exact zeros on a row block that no block covers, and the
same bits on a second call.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from atlite_tpu_torch.ops.bsr_spmm import bsr_spmm, bsr_spmm_kernel, stage_bsr, to_bsr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def case(T, C, B, bb, bc, seed=0, density=0.02, nan_cells=0, inf_cells=0,
         empty_row_block=False):
    rng = np.random.default_rng(seed)
    m = sp.random(B, C, density=density, random_state=seed, format="lil", dtype=np.float32)
    if empty_row_block:
        m[bb:2 * bb] = 0.0  # the second row block holds no entry
    flat = rng.random((T, C), dtype=np.float32)
    flat[rng.integers(0, T, nan_cells), rng.integers(0, C, nan_cells)] = np.nan
    flat[rng.integers(0, T, inf_cells), rng.integers(0, C, inf_cells)] = np.inf
    flat[rng.integers(0, T, inf_cells), rng.integers(0, C, inf_cells)] = -np.inf
    return to_bsr(m.tocsr(), block_b=bb, block_c=bc), flat


def region_case(ny_cells, nx_cells, ny, nx, T, seed=0):
    """chip_smoke's region matrix on a small grid: every cell to one of
    ny x nx rectangles, weight 1, so each column holds one nonzero."""
    iy = np.minimum(np.arange(ny_cells) * ny // ny_cells, ny - 1)
    ix = np.minimum(np.arange(nx_cells) * nx // nx_cells, nx - 1)
    bus = (iy[:, None] * nx + ix[None, :]).ravel()
    C = bus.size
    m = sp.csr_matrix((np.ones(C, dtype=np.float32), (bus, np.arange(C))), shape=(ny * nx, C))
    return to_bsr(m), np.random.default_rng(seed).random((T, C), dtype=np.float32)


def check(bsr, flat, device):
    f = torch.as_tensor(flat, device=device)  # a tensor on the card stays as it is
    before = bsr_spmm_kernel.launches
    got = bsr_spmm_kernel(bsr, f)
    again = bsr_spmm_kernel(stage_bsr(bsr, device), f)
    torch.cuda.synchronize()
    assert bsr_spmm_kernel.launches == before + 2
    assert torch.equal(got.isnan(), again.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(again))  # same bits
    want = bsr_spmm(bsr, f)
    assert got.shape == want.shape == (flat.shape[0], bsr["B"])
    g, w = got.cpu().double(), want.cpu().double()
    assert torch.equal(g.isnan(), w.isnan())
    assert torch.equal(g.isinf(), w.isinf())
    assert torch.equal(g[w.isinf()], w[w.isinf()])  # the same signs
    ok = torch.isfinite(w)
    if ok.any():
        assert float((g[ok] - w[ok]).abs().max()) <= 1e-5 * float(w[ok].abs().max())
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("T, C, B, bb, bc", [
    (100, 3000, 37, 8, 256), (721, 5000, 70, 32, 512), (45, 700, 19, 4, 8),
    (130, 2049, 65, 40, 100)])
def test_kernel_matches_plain_on_card(cuda_device, T, C, B, bb, bc):
    check(*case(T, C, B, bb, bc), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("bb, bc", [(8, 256), (32, 512), (4, 8)])
def test_kernel_nan_cells(cuda_device, bb, bc):
    g = check(*case(77, 1500, 50, bb, bc, seed=1, density=0.05, nan_cells=6), cuda_device)
    assert g.isnan().any() and not g.isnan().all()


@pytest.mark.cuda
@pytest.mark.parametrize("bb, bc", [(8, 256), (32, 512), (4, 8)])
def test_kernel_empty_row_block_is_zero(cuda_device, bb, bc):
    bsr, flat = case(50, 900, 3 * bb, bb, bc, seed=2, density=0.1, empty_row_block=True)
    assert 1 not in set(bsr["row_blk"].tolist())
    g = check(bsr, flat, cuda_device)
    assert torch.equal(g[:, bb:2 * bb], torch.zeros_like(g[:, bb:2 * bb]))


@pytest.mark.cuda
@pytest.mark.parametrize("bb, bc", [(8, 256), (32, 512), (4, 8), (40, 100), (100, 512)])
def test_kernel_inf_cells(cuda_device, bb, bc):
    g = check(*case(77, 1501, 50, bb, bc, seed=3, density=0.05, nan_cells=2, inf_cells=5),
              cuda_device)
    assert g.isinf().any() and g.isnan().any()


@pytest.mark.cuda
def test_kernel_inf_only_at_nonzeros(cuda_device):
    """A row whose only entries at an Inf cell are nonzero gives +-Inf, the
    rows with a stored zero there give NaN."""
    m = sp.lil_matrix((8, 40), dtype=np.float32)
    m[0, 0:8] = 1.0
    m[1, 3] = 2.0
    m[2, 5] = -1.0
    m[5, 12] = 1.0
    flat = np.ones((3, 40), dtype=np.float32)
    flat[0, 3], flat[1, 3], flat[2, 5] = np.inf, -np.inf, np.inf
    g = check(to_bsr(m.tocsr(), block_b=4, block_c=8), flat, cuda_device)
    inf, nan = float("inf"), float("nan")
    want = torch.tensor([[inf, inf, nan, nan], [-inf, -inf, nan, nan], [inf, nan, -inf, nan]],
                        dtype=torch.float64)
    assert torch.equal(g[:, :4].isnan(), want.isnan())
    assert torch.equal(g[:, :4][want.isinf()], want[want.isinf()])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [720, 37])
def test_kernel_region_matrix(cuda_device, T):
    """The phase 11 structure (one nonzero a column, two row blocks per
    region row) on a 61 x 121 grid, odd C, with NaN, +Inf and -Inf cells."""
    bsr, flat = region_case(61, 121, 8, 16, T)
    assert bsr["C"] % 4 == 1
    check(bsr, flat, cuda_device)
    rng = np.random.default_rng(4)
    for v in (np.nan, np.inf, -np.inf):
        flat[rng.integers(0, T, 4), rng.integers(0, bsr["C"], 4)] = v
    g = check(bsr, flat, cuda_device)
    assert g.isnan().any() and g.isinf().any()


@pytest.mark.cuda
@pytest.mark.parametrize("T, C", [(17, 3001), (33, 3002), (16, 3003), (1, 1999)])
def test_kernel_misaligned_rows_and_ragged_tiles(cuda_device, T, C):
    """Rows of the field that start off a 16 B boundary (C % 4 != 0), T not
    a multiple of the time tile, B not a multiple of bb, a field that
    starts off a 16 B boundary itself, blocks wider than a slab, and row
    blocks taller than a thread block's 64 rows (bb = 100)."""
    for bb, bc in ((32, 512), (8, 1300), (40, 100), (100, 512)):
        bsr, flat = case(T, C, 3 * bb - 5, bb, bc, seed=C, density=0.05, nan_cells=1,
                         inf_cells=1)
        check(bsr, flat, cuda_device)
        shifted = torch.as_tensor(np.concatenate([[0.0], flat.ravel()]).astype(np.float32),
                                  device=cuda_device)[1:].view(T, C)  # 4 B into its storage
        check(bsr, shifted, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("bb, bc", [(4, 8), (2, 4), (8, 256)])
def test_kernel_stored_zeros_and_nan_weights(cuda_device, bb, bc):
    """Explicit stored zeros and -0.0 are zeros (a non-finite value there
    gives NaN), a NaN weight is an entry."""
    rows = [0, 0, 1, 2, 3, 5, 6, 9, 9]
    cols = [1, 7, 7, 3, 12, 0, 9, 2, 14]
    vals = np.array([0.0, 2.0, -0.0, np.nan, 1.5, 0.0, -3.0, -0.0, 0.0], dtype=np.float32)
    m = sp.csr_matrix((vals, (rows, cols)), shape=(11, 16))
    flat = np.ones((5, 16), dtype=np.float32)
    flat[0, 7], flat[1, 3], flat[2, 12], flat[3, 1] = np.inf, -np.inf, np.nan, np.inf
    g = check(to_bsr(m, block_b=bb, block_c=bc), flat, cuda_device)
    assert g.isnan().any() and g.isinf().any()


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back(cuda_device):
    bsr, flat = case(10, 300, 9, 8, 256)
    with pytest.raises(TypeError, match="float32"):
        bsr_spmm_kernel(bsr, torch.as_tensor(flat, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError, match="not on"):
        bsr_spmm_kernel(stage_bsr(bsr, "cpu"), torch.as_tensor(flat, device=cuda_device))
