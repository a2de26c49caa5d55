"""The streamer's copy count on a CUDA card: a streamed call counts one
copy to the card a chunk (``convert._Stager.copies``), one chunk or
several, and the series equal the resident call's within 1e-5 * max
(raw) and bit for bit between calls.  Without a card these tests skip;
they import neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_stream_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from atlite_tpu_torch import Cutout, convert


@pytest.fixture(scope="module")
def cut():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the streamer copies to the card only there")
    return Cutout(module="synthetic", x=slice(-4, 1.5), y=slice(56, 62),
                  time=slice("2013-01-01", "2013-01-03")).prepare()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk, chunks", [(72, 1), (24, 3), (30, 3)])
@pytest.mark.parametrize("pack", [None, "int16"])
def test_one_copy_a_chunk(cut, chunk, chunks, pack):
    m = sp.random(3, cut.shape[0] * cut.shape[1], density=0.3, random_state=1, format="csr")
    want = cut.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None).values
    convert._Stager.copies = 0
    got = cut.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None, time_chunk=chunk,
                   stream_pack=pack).values
    assert convert._Stager.copies == chunks
    assert got.shape == want.shape == (3, 72)
    tol = 1e-5 if pack is None else 3e-3
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
