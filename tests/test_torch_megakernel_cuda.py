"""The fused CUDA kernel against its plain PyTorch version, on a card.

The kernel has no CPU mode, so these tests skip without a CUDA card.  They
import neither JAX nor the JAX package, so they also run on a machine that
has only PyTorch; there, skip this directory's conftest (which imports
JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_megakernel_cuda.py

Tolerance: max abs diff within 1e-5 * max|plain| per output (float32 sums
over the cells in another order than the plain matmul), NaN masks
identical.
"""

import numpy as np
import pytest
import torch

from atlite_tpu_torch import build_inputs
from atlite_tpu_torch.entry import PANEL
from atlite_tpu_torch.ops.megakernel import (
    FIELD_ORDER,
    wind_pv_bus_megakernel,
    wind_pv_bus_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def card_inputs(T, Y, X, B, device, nan_cells=4):
    fields, _, _, lat, V, POWn, matrix = build_inputs(T, Y, X, B)
    rng = np.random.default_rng(11)
    fields["wnd100m"][tuple(rng.integers(0, n, nan_cells) for n in (T, Y, X))] = np.nan
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)
    flat = {k: put(fields[k].reshape(T, -1)) for k in FIELD_ORDER}
    return flat, put(np.repeat(lat, X)), put(matrix), put(V), put(POWn)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(48, 16, 24, 5), (30, 7, 13, 3), (45, 9, 20, 37),
                                   (100, 12, 40, 70)])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    args = card_inputs(*shape, device=cuda_device)
    before = wind_pv_bus_megakernel.launches
    got = wind_pv_bus_megakernel(*args, PANEL)
    torch.cuda.synchronize()
    assert wind_pv_bus_megakernel.launches == before + 1
    want = wind_pv_bus_plain(*args, PANEL)
    for g, w in zip(got, want):
        assert g.shape == (shape[0], shape[3]) and g.device.type == "cuda"
        g, w = g.cpu().double(), w.cpu().double()
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert float((g[ok] - w[ok]).abs().max()) <= 1e-5 * float(w[ok].abs().max())


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back(cuda_device):
    """Tensors split between the card and the CPU are refused, not moved."""
    flat, lat_cell, matrix, V, POWn = card_inputs(10, 3, 5, 2, device=cuda_device)
    with pytest.raises(ValueError, match="not on"):
        wind_pv_bus_megakernel(flat, lat_cell, matrix.cpu(), V, POWn, PANEL)
