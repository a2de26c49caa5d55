"""The BSR CUDA kernel (port of ``bsr_spmm_pallas``) against its plain
PyTorch version, on a card.

The kernel has no CPU mode, so these tests skip without a CUDA card.  They
import neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_bsr_cuda.py

Tolerance: max abs diff within 1e-5 * max|plain| (float32 sums over a
block row in another order than cuBLAS and index_add_), NaN masks
identical (the dense-in-block rule: a NaN entry times a stored zero is
NaN), exact zeros on a row block that no block covers, and the same bits
on a second call.
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


def case(T, C, B, bb, bc, seed=0, density=0.02, nan_cells=0, empty_row_block=False):
    rng = np.random.default_rng(seed)
    m = sp.random(B, C, density=density, random_state=seed, format="lil", dtype=np.float32)
    if empty_row_block:
        m[bb:2 * bb] = 0.0  # the second row block holds no entry
    flat = rng.random((T, C), dtype=np.float32)
    flat[rng.integers(0, T, nan_cells), rng.integers(0, C, nan_cells)] = np.nan
    return to_bsr(m.tocsr(), block_b=bb, block_c=bc), flat


def check(bsr, flat, device):
    f = torch.as_tensor(flat, device=device)
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
    ok = ~w.isnan()
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
def test_kernel_raises_instead_of_falling_back(cuda_device):
    bsr, flat = case(10, 300, 9, 8, 256)
    with pytest.raises(TypeError, match="float32"):
        bsr_spmm_kernel(bsr, torch.as_tensor(flat, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError, match="not on"):
        bsr_spmm_kernel(stage_bsr(bsr, "cpu"), torch.as_tensor(flat, device=cuda_device))
