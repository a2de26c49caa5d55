"""The streamer's counters on a CUDA card: a streamed call counts one
copy to the card a chunk (``Cutout._stream_copies``), one chunk or
several, the bytes of the host stacks it copied (``streamed_bytes``) and
the seconds its worker packed and its caller waited (``stream_pack_s``,
``stream_wait_s``), which a resident call leaves as they were; the
series equal the resident call's within 1e-5 * max (raw) and bit for bit
between calls; a second streamed call reuses the Cutout's pinned ring.
At PyPSA-Eur's size (23,711 cells x 8760 h, 2048 regions) an int16 onwind
call streams 12 chunks of 730 h through the banded aggregation.  Without
a card these tests skip; they import neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_stream_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from atlite_tpu_torch import Cutout
from atlite_tpu_torch.core.grid import Grid
from atlite_tpu_torch.ops import bsr_spmm


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
    Cutout._stream_copies = 0
    got = cut.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None, time_chunk=chunk,
                   stream_pack=pack).values
    assert Cutout._stream_copies == chunks
    assert got.shape == want.shape == (3, 72)
    tol = 1e-5 if pack is None else 3e-3
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("pack", [None, "int16"])
def test_second_streamed_call_reuses_the_ring(cut, pack):
    c = Cutout(data=dict(cut.data), grid_desc=cut.grid_desc, attrs=dict(cut.attrs),
               var_attrs=dict(cut.var_attrs))
    m = sp.random(3, c.shape[0] * c.shape[1], density=0.3, random_state=1, format="csr")
    kw = dict(matrix=m, aggregate_time=None, time_chunk=30, stream_pack=pack)
    first = c.wind("Vestas_V112_3MW", **kw).values
    ring = c._ring
    pinned = [b.data_ptr() for b in ring._buffers]
    assert all(b.is_pinned() for b in ring._buffers)
    second = c.wind("Vestas_V112_3MW", **kw).values
    assert c._ring is ring and [b.data_ptr() for b in ring._buffers] == pinned
    np.testing.assert_array_equal(second, first)


def counters():
    return Cutout.streamed_bytes, Cutout.stream_pack_s, Cutout.stream_wait_s


@pytest.mark.cuda
@pytest.mark.parametrize("chunk, chunks", [(72, 1), (24, 3)])
@pytest.mark.parametrize("pack", [None, "int16"])
def test_streamer_counts_bytes_and_seconds(cut, chunk, chunks, pack):
    ncells = cut.shape[0] * cut.shape[1]
    m = sp.random(3, ncells, density=0.3, random_state=1, format="csr")
    kw = dict(matrix=m, aggregate_time=None)
    before = counters()
    cut.wind("Vestas_V112_3MW", **kw)
    assert counters() == before
    cut.wind("Vestas_V112_3MW", time_chunk=chunk, stream_pack=pack, **kw)
    after = counters()
    fields = len({"wnd100m", "wnd10m", "roughness"})  # the speeds and the log law's roughness
    assert after[0] - before[0] == chunks * fields * chunk * ncells * (2 if pack else 4)
    assert after[1] > before[1] and after[2] > before[2]


@pytest.mark.cuda
def test_pypsa_eur_year_streams_twelve_banded_chunks(monkeypatch):
    """PyPSA-Eur's era5 grid (131 x 181 cells at 0.3 deg) over 2013, the
    two fields onwind streams, 2048 rectangular regions: one int16 call
    in 730 h chunks copies 12 chunks of codes and aggregates each through
    the banded product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the streamer copies to the card only there")
    rng = np.random.default_rng(2013)
    T, Y, X = 8760, 131, 181
    data = {"wnd100m": rng.uniform(0.0, 25.0, (T, Y, X)).astype(np.float32),
            "roughness": np.broadcast_to(
                np.exp(rng.uniform(np.log(2e-4), np.log(1.2), (Y, X))).astype(np.float32),
                (T, Y, X))}
    grid = Grid(x=-12.0 + 0.3 * np.arange(X), y=33.0 + 0.3 * np.arange(Y),
                time=np.datetime64("2013-01-01T00", "ns") + np.arange(T) * np.timedelta64(1, "h"),
                crs=4326)
    c = Cutout(data=data, grid_desc=grid, attrs={"module": "era5", "dx": 0.3, "dy": 0.3})
    j, i = np.divmod(np.arange(Y * X), X)
    m = sp.csr_matrix((np.ones(Y * X), ((j * 32 // Y) * 64 + i * 64 // X, np.arange(Y * X))),
                      shape=(2048, Y * X))
    products = []
    banded = bsr_spmm.banded_spmm

    def counted(*args, **kwargs):
        products.append(1)
        return banded(*args, **kwargs)
    monkeypatch.setattr(bsr_spmm, "banded_spmm", counted)
    copies, before = Cutout._stream_copies, counters()
    got = c.wind("Vestas_V112_3MW", matrix=m, per_unit=True, aggregate_time=None,
                 time_chunk=730, stream_pack="int16").values
    after = counters()
    assert Cutout._stream_copies - copies == 12 and len(products) == 12
    assert after[0] - before[0] == 12 * 2 * 730 * Y * X * 2
    assert after[1] > before[1] and after[2] >= before[2]
    assert got.shape == (2048, T) and np.isfinite(got).all()
