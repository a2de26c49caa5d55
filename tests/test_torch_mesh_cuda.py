"""The port's mesh on a CUDA card: the card repeated to 8 mesh positions.

The fused kernel has no CPU mode, so the sharded step's launches (one a
shard) and the card-to-host gather after queued work are held here, on a
card; without one these tests skip.  They import neither JAX nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py

Tolerance: the sharded step against the unsharded one within 1e-5 *
max|unsharded| (the partial bus series add in another order), NaN masks
identical; gathers exact.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from atlite_tpu_torch import Cutout, build_inputs, dryrun_multichip, from_jax_inputs
from atlite_tpu_torch.core.mesh import (
    NamedSharding,
    field_spec,
    make_mesh,
    map_shards,
    put_global,
    shard_fields,
)
from atlite_tpu_torch.entry import sharded_step_fn, step_fn
from atlite_tpu_torch.ops.megakernel import wind_pv_bus_megakernel

REL_TOL = 1e-5


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernel has no CPU mode")
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(8)]


def close(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert float((got[ok] - want[ok]).abs().max()) <= REL_TOL * float(want[ok].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 4, 2])
def test_sharded_step_launches_once_a_shard(cards, n):
    host = build_inputs(48, 16, 32, 5)
    host[0]["wnd100m"][3, 4, 5] = np.nan
    args = from_jax_inputs(*host, device="cuda")
    want = step_fn()(*args)
    mesh = make_mesh(cards[:n])
    fields = shard_fields(mesh, args[0])
    before = wind_pv_bus_megakernel.launches
    got = sharded_step_fn(mesh)(fields, *args[1:])
    assert wind_pv_bus_megakernel.launches - before == n
    for g, w in zip(got, want):
        close(g.gather(), w)


@pytest.mark.cuda
def test_gather_to_the_host_waits_for_queued_work(cards):
    """A card-to-host gather behind a long queue of kernels returns their
    results (a non-blocking copy to the host would read the buffer early)."""
    mesh = make_mesh(cards)
    a = torch.rand((64, 32, 64), device="cuda")
    s = put_global(a, NamedSharding(mesh, field_spec()))
    slow = map_shards(lambda b: torch.stack([b * (k + 1) for k in range(64)]).sum(0), s)
    want = a * (64 * 65 / 2)
    torch.testing.assert_close(slow.gather("cpu"), want.cpu(), rtol=1e-6, atol=0)
    torch.testing.assert_close(slow.gather(), want, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_sharded_cutout_on_the_card(cards):
    kw = dict(module="synthetic", x=slice(-4, 1.76), y=slice(56, 62), time="2013-01-01")
    plain = Cutout(**kw).prepare(features=["wind", "influx", "temperature"])
    sharded = Cutout(**kw).prepare(features=["wind", "influx", "temperature"])
    sharded.shard(make_mesh(cards))
    C = plain.shape[0] * plain.shape[1]
    m = sp.random(4, C, density=0.3, random_state=3, format="csr", dtype=np.float32)
    for fn in (lambda c: c.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None),
               lambda c: c.pv(panel="CSi", orientation="latitude_optimal", matrix=m,
                              aggregate_time=None)):
        close(torch.as_tensor(fn(sharded).values), torch.as_tensor(fn(plain).values))
    with pytest.raises(ValueError, match="unshard"):
        sharded.wind("Vestas_V112_3MW", matrix=m, time_chunk=12)


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card(cards):
    dryrun_multichip(8)
    dryrun_multichip(4)
