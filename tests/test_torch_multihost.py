"""Multi-process runs of the port (counterpart of tests/test_multihost.py):
2 processes x 4 CPU mesh positions, joined by ``core.comm`` over gloo on a
free local port, each running ``atlite_tpu_torch/core/multihost_worker.py``
over a store the port wrote: the sharded step, the distributed banded
aggregation, per-process reads from the store and the store-to-mesh
pipeline, each held inside the worker against the same computation on one
local device (rtol 2e-4, atol 1e-5, as the JAX worker holds its own).
Here: every worker exits 0 and reaches every stage, each reads exactly
half of the variable's bytes, and ``core.comm`` and the mesh also hold in
one process (where ``initialize`` is a no-op).  300 s a worker, as
tests/test_multihost.py allows.
"""

import re

import numpy as np
import pytest
import torch

from atlite_tpu_torch.core import comm
from atlite_tpu_torch.core.mesh import P, field_spec, make_mesh
from atlite_tpu_torch.entry import _dryrun_multiprocess, dryrun_multichip

torch.set_num_threads(1)

CPU = torch.device("cpu")
STAGES = ("STEP OK", "AGG OK", "STORE OK", "PIPELINE OK", "MULTIHOST OK")


@pytest.fixture(scope="module")
def two_workers(tmp_path_factory):
    return _dryrun_multiprocess(8, 2, devices=[CPU], workdir=tmp_path_factory.mktemp("mh"),
                                timeout=300)


@pytest.mark.parametrize("worker", [0, 1])
def test_two_process_mesh_equals_single_device(two_workers, worker):
    rc, out = two_workers[worker]
    assert rc == 0, out
    for stage in STAGES:
        assert f"proc {worker}: {stage}" in out, out
    assert f"t rows {worker}..{worker + 1}" in out


@pytest.mark.parametrize("worker", [0, 1])
def test_each_process_reads_half_the_store(two_workers, worker):
    read, total = map(int, re.search(r"STORE OK \(read (\d+)/(\d+) bytes\)",
                                     two_workers[worker][1]).groups())
    assert read * 2 == total and total == 24 * 17 * 24 * 4  # float32 (T, Y, X)


def test_dryrun_multichip_with_processes():
    dryrun_multichip(4, n_processes=2, devices=[CPU])


def test_comm_in_one_process(tmp_path):
    from atlite_tpu_torch import Cutout

    comm.initialize()  # no coordinator, no WORLD_SIZE: a single process
    assert comm.process_count() == 1 and comm.is_primary()
    mesh = comm.global_mesh(devices=[CPU] * 8)
    assert mesh.shape == {"t": 1, "x": 8} and mesh.t_offset == 0
    assert comm.global_mesh(t_axis=4, devices=[CPU] * 8).shape == {"t": 4, "x": 2}
    c = Cutout(tmp_path / "one", device="cpu", module="synthetic", x=slice(-4, 1.76),
               y=slice(56, 58), time="2013-01-01").prepare(features=["wind"])
    mesh = make_mesh([CPU] * 8)
    before = comm.SHARD_BYTES_READ
    arr = comm.from_store(mesh, field_spec(), tmp_path / "one", "wnd100m")
    full = np.asarray(c.data["wnd100m"])
    assert comm.SHARD_BYTES_READ - before == full.nbytes  # every piece once
    np.testing.assert_array_equal(comm.allgather(arr), full)
    a = np.arange(16.0)
    np.testing.assert_array_equal(comm.allgather(comm.from_global_numpy(mesh, P("t"), a)), a)
    comm.barrier("one")


def test_initialize_needs_a_rank(monkeypatch):
    monkeypatch.setattr(comm, "_initialized", False)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="process_id"):
        comm.initialize()
