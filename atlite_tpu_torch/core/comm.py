"""Multi-process execution (counterpart of ``atlite_tpu/core/comm.py``).

The ("t", "x") decomposition of ``core/mesh.py`` spans processes along
"t" only: time shards are independent, so processes exchange nothing per
step; the "x" axis (halo exchange, the sum of partial bus series) stays
among each process's own devices.  Processes meet through
``torch.distributed`` only to gather host results and to wait for each
other, over gloo on the CPU.  No collective ever runs on CUDA tensors, so
NCCL, which refuses two ranks on one card, is never engaged, and several
processes may share one card.

Usage (one call per process, before any other use):

    from atlite_tpu_torch.core import comm
    comm.initialize()                      # from the environment, or explicit
    mesh = comm.global_mesh()              # "t" spans all processes
    arr = comm.from_store(mesh, spec, store_path, "wnd100m")
    ...
    result = comm.allgather(out)           # the full array on every process

``core/multihost_worker.py`` runs the sharded step, the distributed
banded aggregation and the store-to-mesh pipeline so, against one
device's results (``entry.dryrun_multichip(..., n_processes=2)``).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from atlite_tpu_torch.core.mesh import (
    Mesh,
    NamedSharding,
    ShardedTensor,
    make_mesh,
    place,
    put_global,
)
from atlite_tpu_torch.core.store import MANIFEST, var_path

logger = logging.getLogger(__name__)

_initialized = False
_host_group = None  # the gloo group of the host collectives


def initialize(coordinator_address=None, num_processes=None, process_id=None, **kwargs):
    """Idempotent start of ``torch.distributed`` between processes.

    ``coordinator_address`` is "host:port" of process 0; the arguments
    default to torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  A no-op for a single process, and when
    ``torch.distributed`` was already started (by this function or by the
    caller).  The process group is ``backend="cpu:gloo,cuda:nccl"`` (gloo
    alone where PyTorch has no NCCL): host collectives go through gloo, and
    NCCL would only be set up by a collective on CUDA tensors, which
    nothing here issues, since t shards are independent.  That is what
    lets several processes share one card.  ``kwargs`` go to
    ``init_process_group`` (e.g. ``timeout``).
    """
    global _initialized
    if _initialized:
        return
    if dist.is_available() and dist.is_initialized():
        _initialized = True
        _ensure_host_group()
        return
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', 29500)}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return  # single-process run
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs num_processes and process_id "
                         "(or WORLD_SIZE and RANK)")
    backend = "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"
    kwargs.setdefault("timeout", datetime.timedelta(seconds=300))
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kwargs)
    _initialized = True
    _ensure_host_group()
    logger.info("torch.distributed initialized (%s): process %d/%d", backend,
                dist.get_rank(), dist.get_world_size())


def _ensure_host_group():
    """A gloo group for the host collectives, where the default group is
    not gloo alone (every process calls this, as group creation is itself
    collective)."""
    global _host_group
    if _host_group is None and dist.get_backend() != "gloo":
        _host_group = dist.new_group(backend="gloo")


def _started():
    return dist.is_available() and dist.is_initialized()


def process_count():
    return dist.get_world_size() if _started() else 1


def is_primary():
    return not _started() or dist.get_rank() == 0


def global_mesh(t_axis=None, devices=None):
    """("t", "x") mesh over every process's devices.

    ``devices`` are this process's (default: its CUDA cards; they may
    repeat, e.g. ``[torch.device("cuda", 0)] * 4``, or be CPU devices);
    every process passes as many.  "x" stays within a process (the
    largest x dividing the local count), so halos and partial sums never
    leave it; "t" spans processes: this process holds t rows [rank *
    t_local, (rank + 1) * t_local).  ``t_axis`` is the global t size."""
    local = make_mesh(devices).devices.ravel().tolist()
    n_local, n_proc = len(local), process_count()
    if t_axis is None:
        x_axis = next(x for x in range(n_local, 0, -1) if n_local % x == 0)
    else:
        if t_axis % n_proc:
            raise ValueError(f"t={t_axis} does not split over {n_proc} processes")
        x_axis = n_local // (t_axis // n_proc)
    t_local = n_local // x_axis
    if t_local * x_axis != n_local:
        raise ValueError(f"{n_local} local devices do not factor into (t, x={x_axis})")
    rank = dist.get_rank() if _started() else 0
    rows = [local[i * x_axis:(i + 1) * x_axis] for i in range(t_local)]
    return Mesh(rows, t_offset=rank * t_local, t_size=t_local * n_proc,
                process_index=rank, process_count=n_proc)


def from_global_numpy(mesh, spec, array):
    """Place a global numpy array, held whole by every process, onto the
    mesh: each process places only its own blocks.  For data persisted in
    a cutout store use :func:`from_store`, which never reads the global
    array anywhere."""
    return put_global(np.asarray(array), NamedSharding(mesh, spec))


# bytes copied out of store memory maps by from_store in this process: the
# observable of "each process reads only its own time shard"
SHARD_BYTES_READ = 0


def from_store(mesh, spec, store_path, var, dtype=None):
    """Shard a stored cutout variable onto the mesh with per-process reads.

    The variable's ``.npy`` file is memory-mapped (``core/store.py``) and
    only the blocks of this process's mesh positions are copied out of it,
    each once, so a process reads ~1/n_processes of the file (counted in
    ``SHARD_BYTES_READ``); the store is the shared file, the mesh decides
    which bytes each process touches."""
    path = Path(store_path)
    if path.suffix != ".atc" and (path.parent / (path.name + ".atc")).exists():
        path = path.parent / (path.name + ".atc")
    manifest = json.loads((path / MANIFEST).read_text())
    arr = np.load(var_path(path, manifest, var), mmap_mode="r")

    def read(sl):
        global SHARD_BYTES_READ
        out = np.array(arr[sl])
        if dtype is not None:
            out = out.astype(dtype)
        SHARD_BYTES_READ += out.nbytes
        return out

    return place(mesh, spec, arr.shape, read)


def allgather(arr):
    """The full array of a ShardedTensor (or a tensor or array) as numpy
    on every process: this process's part, then every process's parts in
    process order along the dimension that "t" splits, over gloo."""
    local = arr.gather("cpu") if isinstance(arr, ShardedTensor) else arr
    local = local.detach().cpu().numpy() if isinstance(local, torch.Tensor) else np.asarray(local)
    if process_count() == 1 or not isinstance(arr, ShardedTensor):
        return local
    split = [d for d, (a, k) in enumerate(zip(arr.spec, arr.parts)) if a == "t" and k > 1]
    if not split:
        return local  # "t" whole: every process holds all of it
    parts = [None] * process_count()
    dist.all_gather_object(parts, local, group=_host_group)
    return np.concatenate(parts, axis=split[0])


def barrier(name="barrier"):
    """Wait until every process got here (over gloo)."""
    if process_count() > 1:
        logger.debug("barrier %s", name)
        dist.barrier(group=_host_group)
