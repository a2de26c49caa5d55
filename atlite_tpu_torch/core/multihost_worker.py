"""One process of a multi-process run (counterpart of the JAX package's
``tests/multihost_worker.py``): the sharded headline step, the
distributed banded aggregation, per-process reads from a store and the
store-to-mesh pipeline over a process-spanning mesh, each held against
the same computation on one local device.

    python -m atlite_tpu_torch.core.multihost_worker <process_id> \\
        <num_processes> <port> <store> <cpu|cuda> <local_devices>

Each process joins ``core.comm`` on ``localhost:<port>`` over gloo and
holds ``local_devices`` mesh positions: CPU devices, or the visible cards
in turn (one card repeated when it is the only one).  It prints a line a
stage ("STEP OK", "AGG OK", "STORE OK (read r/g bytes)", "PIPELINE OK")
and "MULTIHOST OK"; any failure exits non-zero.
"""

from __future__ import annotations

import sys

import numpy as np
import scipy.sparse as sp
import torch


def _devices(kind, n):
    if kind == "cpu":
        return [torch.device("cpu")] * n
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("no CUDA card is available")
    return [torch.device("cuda", i % cards) for i in range(n)]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    proc_id, nproc, port, store = int(argv[0]), int(argv[1]), argv[2], argv[3]
    kind, n_local = argv[4], int(argv[5])
    torch.set_num_threads(1)

    from atlite_tpu_torch.entry import example_inputs, from_jax_inputs, sharded_step_fn, step_fn
    from atlite_tpu_torch.convert import _wind_pipeline
    from atlite_tpu_torch.core import comm
    from atlite_tpu_torch.core.mesh import (
        P, field_spec, map_shards, sharded_aggregate_banded, table_spec)
    from atlite_tpu_torch.core.store import read_store

    comm.initialize(coordinator_address=f"localhost:{port}", num_processes=nproc,
                    process_id=proc_id)
    assert comm.process_count() == nproc
    devices = _devices(kind, n_local)
    mesh = comm.global_mesh(devices=devices)
    print(f"proc {proc_id}: {n_local} local {kind} positions, mesh {mesh.shape}, "
          f"t rows {mesh.t_offset}..{mesh.t_offset + mesh.local_shape['t']}", flush=True)
    assert mesh.shape["t"] % nproc == 0, mesh.shape
    t_size, x_size = mesh.shape["t"], mesh.shape["x"]

    T, Y, X, B = 4 * t_size, 8, 4 * x_size, 3
    host = example_inputs(T=T, Y=Y, X=X, B=B)
    fields, eph, lon, lat, V, POWn, matrix = host

    # --- single (local) device expectation
    exp_wind, exp_pv = (o.cpu().numpy() for o in
                        step_fn()(*from_jax_inputs(*host, device=devices[0])))

    # --- the sharded step over the process-spanning mesh
    def fgl(spec, a):
        return comm.from_global_numpy(mesh, spec, a)

    fields_d = {k: fgl(field_spec() if np.ndim(v) == 3 else P(None, "x"), v)
                for k, v in fields.items()}
    eph_d = {k: fgl(table_spec(), v) for k, v in eph.items()}
    wind_bus, pv_bus = sharded_step_fn(mesh)(fields_d, eph_d, lon, lat, V, POWn, matrix)
    got_wind, got_pv = comm.allgather(wind_bus), comm.allgather(pv_bus)
    np.testing.assert_allclose(got_wind, exp_wind, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got_pv, exp_pv, rtol=2e-4, atol=1e-5)
    print(f"proc {proc_id}: STEP OK", flush=True)

    # --- distributed banded aggregation across processes
    rng = np.random.default_rng(1)
    mat = sp.random(B, Y * X, density=0.15, random_state=2, format="csr")
    field = rng.random((T, Y, X)).astype(np.float32)
    agg = sharded_aggregate_banded(mesh, mat, Y, X, block_b=2, align=4)
    got = comm.allgather(agg(fgl(field_spec(), field)))
    np.testing.assert_allclose(got, field.reshape(T, -1) @ mat.toarray().T,
                               rtol=1e-4, atol=1e-5)
    print(f"proc {proc_id}: AGG OK", flush=True)

    # --- per-process time-shard reads from the .atc store
    var = "wnd100m"
    _, raw, _, _ = read_store(store)
    full = raw[var]
    global_bytes = full.size * full.itemsize
    before = comm.SHARD_BYTES_READ
    arr = comm.from_store(mesh, field_spec(), store, var)
    read = comm.SHARD_BYTES_READ - before
    expected = global_bytes // nproc
    assert read == expected, (f"proc {proc_id} read {read} bytes from the store, expected "
                              f"exactly its 1/{nproc} time shard = {expected}")
    # the sharded array holds the store's values
    np.testing.assert_array_equal(comm.allgather(arr), np.asarray(full))
    print(f"proc {proc_id}: STORE OK (read {read}/{global_bytes} bytes)", flush=True)

    # --- the pipeline end to end: store scatter -> sharded wind
    # conversion -> distributed banded aggregation -> one (T, B) result,
    # equal to a single device's
    Ts, Ys, Xs = full.shape
    wind_vars = ["wnd100m", "wnd10m", "roughness"]
    fields_s = {v: comm.from_store(mesh, field_spec(), store, v) for v in wind_vars}
    V2 = np.arange(0.0, 26.0, 0.5, dtype=np.float32)
    POW2 = np.clip((V2**3 - 27.0) / (12.0**3 - 27.0), 0, 1).astype(np.float32)
    POW2[V2 >= 25.0] = 0.0
    mat2 = sp.random(5, Ys * Xs, density=0.2, random_state=3, format="csr")
    agg2 = sharded_aggregate_banded(mesh, mat2, Ys, Xs, block_b=2, align=4)

    def wind_cf(fl):
        dev = fl["wnd100m"].device
        return _wind_pipeline(fl, torch.as_tensor(V2, device=dev),
                              torch.as_tensor(POW2, device=dev), 80.0, "logarithmic")

    cf = map_shards(wind_cf, fields_s)
    got2 = comm.allgather(agg2(cf))
    cf1 = wind_cf({v: torch.as_tensor(np.array(raw[v], dtype=np.float32), device=devices[0])
                   for v in wind_vars})
    exp2 = cf1.reshape(Ts, -1).double().cpu().numpy() @ mat2.toarray().T
    np.testing.assert_allclose(got2, exp2, rtol=2e-4, atol=1e-5)
    print(f"proc {proc_id}: PIPELINE OK", flush=True)

    comm.barrier("done")
    print(f"proc {proc_id}: MULTIHOST OK", flush=True)


if __name__ == "__main__":
    main()
