"""Entry points of the headline step (counterparts of
``__graft_entry__._example_inputs``/``_step_fn``/``entry`` and
``bench.build_inputs``).

The step turns stored weather fields into wind and PV bus series.  On a
CUDA card it runs as one fused kernel (``ops/csrc/megakernel.cu``); on the
CPU the same call runs the plain modules.  Inputs are made by the JAX
package's recipe, with numpy alone, and ``from_jax_inputs`` carries either
package's numpy inputs onto a device.  ``sharded_step_fn`` runs the step
over a ("t", "x") mesh (``core/mesh.py``), the fused kernel once a shard,
and ``dryrun_multichip`` holds that against the unsharded step, in one
process or several.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from atlite_tpu_torch.core.device import resolve_device
from atlite_tpu_torch.core.mesh import (
    ShardedTensor,
    _shard_columns,
    _sum_over_x,
    make_mesh,
    shard_fields,
    sharded_aggregate_banded,
)
from atlite_tpu_torch.core.timeutil import solar_ephemeris
from atlite_tpu_torch.cutout import Cutout
from atlite_tpu_torch.datasets import synthetic
from atlite_tpu_torch.ops.megakernel import FIELD_ORDER, Plan, knot_table, wind_pv_bus_megakernel
from atlite_tpu_torch.physics.wind import simplify_power_curve
from atlite_tpu_torch.profiling import span

# the panel of __graft_entry__._step_fn
PANEL = {
    "model": "huld", "efficiency": 0.17, "r_irradiance": 1000.0,
    "r_tmod": 298.0, "c_temp_amb": 1.0, "c_temp_irrad": 0.035,
    "inverter_efficiency": 0.9, "k_1": -0.017162, "k_2": -0.040289,
    "k_3": -0.004681, "k_4": 0.000148, "k_5": 0.000169, "k_6": 0.000005,
}
HUB_HEIGHT = 80.0


def example_inputs(T=24, Y=16, X=32, B=4, seed=7,
                   extent=(-10, 5, 40, 55), start="2013-06-01",
                   density=0.2, matrix_seed=0, vin=3.0):
    """Synthetic numpy inputs of the step, by the recipe of
    ``__graft_entry__._example_inputs``: (fields, eph, lon, lat, V, POWn,
    matrix)."""
    x = np.linspace(extent[0], extent[1], X)
    y = np.linspace(extent[2], extent[3], Y)
    times = np.datetime64(start, "ns") + np.arange(T) * np.timedelta64(1, "h")
    fields = {}
    for feature in ("wind", "influx", "temperature", "height"):
        for var, (dims, arr) in synthetic.generate(feature, x, y, times, seed).items():
            fields[var] = np.asarray(arr, dtype=np.float32)
    eph = {k: np.asarray(v, dtype=np.float32)
           for k, v in solar_ephemeris(times).items()}

    rng = np.random.default_rng(matrix_seed)
    matrix = rng.random((B, Y * X), dtype=np.float32)
    matrix *= rng.random((B, Y * X)) < density

    # simple cubic-ramp power curve
    V = np.arange(0.0, 26.0, 0.5, dtype=np.float32)
    POWn = np.clip((V**3 - vin**3) / (12.0**3 - vin**3), 0, 1).astype(np.float32)
    POWn[V >= 25.0] = 0.0
    return fields, eph, x.astype(np.float32), y.astype(np.float32), V, POWn, matrix


def build_inputs(T, Y, X, B, seed=3):
    """Inputs at a bench shape, by the recipe of ``bench.build_inputs``:
    Europe at 0.25 deg, a winter start, a sparser bus matrix and the
    simplified power curve."""
    fields, eph, x, y, V, POWn, matrix = example_inputs(
        T=T, Y=Y, X=X, B=B, seed=seed, extent=(-12.0, 18.0, 35.0, 60.0),
        start="2013-01-01", density=0.05)
    V, POWn = (a.astype(np.float32) for a in simplify_power_curve(V, POWn))
    return fields, eph, x, y, V, POWn, matrix


def from_jax_inputs(fields, eph, lon, lat, V, POWn, matrix, device=None):
    """Carry numpy inputs (as either package makes them) to tensors on a
    device, float32 where they are floating point."""
    device = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return ({k: put(v) for k, v in fields.items()},
            {k: put(v) for k, v in eph.items()},
            put(lon), put(lat), put(V), put(POWn), put(matrix))


def _versions(tensors):
    """What a kept plan must still match in ``tensors`` besides their
    identities: each one's version, base pointer, shape and strides, and
    the CUDA stream current on the first one's card; a key equal to no
    other where a tensor keeps no version (made in inference mode)."""
    device = tensors[0].device
    try:
        return (torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else None,
                *[(t._version, t.data_ptr(), t.shape, t.stride()) for t in tensors])
    except RuntimeError:
        return object()


def _same(tensors, held):
    """Whether ``tensors`` are the very ``held`` ones, unchanged since."""
    return (len(tensors) == len(held[0]) and all(a is b for a, b in zip(tensors, held[0]))
            and _versions(tensors) == held[1])


def step_fn():
    """The headline step: ``step(fields, eph, lon, lat, V, POWn, matrix) ->
    (wind_bus, pv_bus)``, each (T, B), with the signature of
    ``__graft_entry__._step_fn``.  ``eph`` is unused: the step takes the
    stored solar angles.  The step keeps the kernel's launch plan
    (``megakernel.Plan``: the flat (T, C) views of the nine fields, the
    cells' latitudes, the kernel's arguments and scratch) for the fields,
    ``lat``, ``V`` and ``POWn`` it was last given, and builds it again when
    one of them is another tensor or was written, moved or reshaped since,
    or another CUDA stream is current; the matrix may change from call to
    call.  It keeps the knot table of the power curve alike.  So it holds
    its last inputs until it is given others.  Each call goes through
    ``wind_pv_bus_megakernel`` with the kept plan.  Its key and, on a
    rebuild, the flattening run in a ``pack 0:T`` span (and the kernel's
    own, with its launch in ``convert 0:T``: ``megakernel.Plan``)."""
    last = {"plan": None, "flat": None, "inputs": ((), None), "curve": ((), None), "table": None}

    def step(fields, eph, lon, lat, V, POWn, matrix):
        T, Y, X = fields["wnd100m"].shape
        with span("pack", 0, T):
            inputs = (*[fields[k] for k in FIELD_ORDER], lat, V, POWn)
            hit = _same(inputs, last["inputs"])
            if not hit:
                flat = {k: fields[k].reshape(T, Y * X) for k in FIELD_ORDER}
                lat_cell = lat.repeat_interleave(X)
                if not _same((V, POWn), last["curve"]):
                    last.update(table=knot_table(V, POWn), curve=((V, POWn), _versions((V, POWn))))
        if not hit:
            plan = Plan(flat, lat_cell, V, POWn, last["table"], PANEL, HUB_HEIGHT)
            last.update(plan=plan, flat=(flat, lat_cell), inputs=(inputs, _versions(inputs)))
        flat, lat_cell = last["flat"]
        return wind_pv_bus_megakernel(flat, lat_cell, matrix, V, POWn, PANEL,
                                      hub_height=HUB_HEIGHT, plan=last["plan"])

    return step


def entry(device=None):
    """(step, example_args) with the example inputs on ``device`` (default:
    the CUDA card; raises without one)."""
    device = resolve_device(device)
    args = from_jax_inputs(*example_inputs(), device=device)
    return step_fn(), args


def sharded_step_fn(mesh):
    """The headline step over a ("t", "x") mesh: ``step(fields, eph, lon,
    lat, V, POWn, matrix) -> (wind_bus, pv_bus)``, each a ShardedTensor
    ("t", None) of (T, B).

    ``fields`` are (T, Y, X) arrays or ShardedTensors (``shard_fields``);
    ``lat`` (Y,), ``V``, ``POWn`` and the (B, Y*X) ``matrix`` are arrays or
    tensors, staged once on every device (the matrix as each x block's
    columns) and kept while the step is given the same objects.  Each
    block runs ``step_fn()`` on its fields, its latitudes and its columns
    of the matrix (the fused kernel on a card: one launch a block), and
    the partial bus series are summed over "x".  ``eph`` and ``lon`` are
    unused, as in ``step_fn``.
    """
    steps = {}  # one step_fn per device: it keeps that device's knot table
    staged = {"key": None}

    def stage(lat, V, POWn, matrix, Y, X, nxs):
        key = (lat, V, POWn, matrix, Y, X, nxs)
        if staged["key"] is None or any(a is not b for a, b in zip(staged["key"], key)):
            m = matrix.detach().cpu().numpy() if isinstance(matrix, torch.Tensor) \
                else np.asarray(matrix, dtype=np.float32)
            cols = [np.ascontiguousarray(m[:, _shard_columns(Y, X, nxs, j)]) for j in range(nxs)]
            staged.update(key=key, per={}, cols=cols)
        return staged

    def on(device, j, lat, V, POWn):
        """(lat, V, POWn) staged once a device, the columns once a device
        and x block."""
        per = staged["per"]

        def put(a):
            a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
            return a.to(device=device, dtype=torch.float32).contiguous()

        if device not in per:
            per[device] = (put(lat), put(V), put(POWn))
        if (device, j) not in per:
            per[(device, j)] = put(staged["cols"][j])
        return (*per[device], per[(device, j)])

    def step(fields, eph, lon, lat, V, POWn, matrix):
        if not all(isinstance(v, ShardedTensor) for v in fields.values()):
            fields = shard_fields(mesh, fields)
        w = fields["wnd100m"]
        nxs = w.parts[-1]
        Y, X = w[0, 0].shape[1], w[0, 0].shape[2] * nxs
        stage(lat, V, POWn, matrix, Y, X, nxs)
        wind, pv = {}, {}
        for (i, j), b in w.distinct():
            dev = b.device
            lat_d, V_d, POWn_d, cols = on(dev, j, lat, V, POWn)
            local = {k: fields[k][i, j] for k in FIELD_ORDER}
            if dev not in steps:
                steps[dev] = step_fn()
            wind[(i, j)], pv[(i, j)] = steps[dev](local, None, None, lat_d, V_d, POWn_d, cols)
        return _sum_over_x(mesh, wind, w.parts[0]), _sum_over_x(mesh, pv, w.parts[0])

    return step


def _mesh_devices(n_devices, devices=None):
    """``n_devices`` devices for a mesh: the given ones (repeated in turn
    when fewer), else the visible CUDA cards in turn (raises without
    one)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] \
            if torch.cuda.is_available() else []
        if not devices:
            raise RuntimeError("no CUDA card is available; pass devices= (e.g. "
                               "[torch.device('cpu')] * 8) to run on the CPU")
    devices = [torch.device(d) for d in devices]
    return [devices[i % len(devices)] for i in range(n_devices)]


def dryrun_multichip(n_devices: int, n_processes: int = None, devices=None) -> None:
    """Run the sharded headline step on an n-device mesh and hold it
    against the unsharded step; then the distributed banded aggregation
    against ``field @ mat.T``.

    ``devices`` (port only) are the mesh's devices, repeated in turn up to
    ``n_devices`` (default: the visible cards; ``[torch.device("cpu")]``
    runs it on the CPU).  On a card the fused kernel must launch once a
    shard.  With ``n_processes`` > 1, instead start that many processes
    (``n_devices // n_processes`` devices each, of the same type),
    joined by ``core.comm`` over gloo, each running
    ``core/multihost_worker.py`` over a process-spanning mesh and a small
    store; a worker that fails fails the call.
    """
    if n_processes and n_processes > 1:
        _dryrun_multiprocess(n_devices, n_processes, devices)
        return
    devices = _mesh_devices(n_devices, devices)
    mesh = make_mesh(devices)
    t_size, x_size = mesh.shape["t"], mesh.shape["x"]

    # tiny but shard-cleanly-divisible shapes
    T, Y, X, B = 4 * t_size, 8, 4 * x_size, 3
    host = example_inputs(T=T, Y=Y, X=X, B=B)
    fields, eph, lon, lat, V, POWn, matrix = host
    step = sharded_step_fn(mesh)
    before = wind_pv_bus_megakernel.launches
    wind_bus, pv_bus = step(shard_fields(mesh, fields), eph, lon, lat, V, POWn, matrix)
    wind_bus, pv_bus = wind_bus.gather(), pv_bus.gather()
    launched = wind_pv_bus_megakernel.launches - before
    assert wind_bus.shape == (T, B) and pv_bus.shape == (T, B)
    if mesh.device_type == "cuda" and launched != mesh.size:
        raise RuntimeError(f"the sharded step launched the fused kernel {launched} times "
                           f"over {mesh.size} shards")

    # sharded == single-device VALUES, not just finiteness
    exp_wind, exp_pv = step_fn()(*from_jax_inputs(*host, device=devices[0]))
    np.testing.assert_allclose(wind_bus.cpu().numpy(), exp_wind.cpu().numpy(),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(pv_bus.cpu().numpy(), exp_pv.cpu().numpy(),
                               rtol=2e-4, atol=1e-5)

    # the distributed large-matrix aggregation: per-shard column bands and
    # one sum over "x"
    rng = np.random.default_rng(1)
    mat = sp.random(B, Y * X, density=0.1, random_state=2, format="csr")
    agg = sharded_aggregate_banded(mesh, mat, Y, X, block_b=2, align=4)
    field = rng.random((T, Y, X)).astype(np.float32)
    out = agg(field).gather().cpu().numpy()
    np.testing.assert_allclose(out, field.reshape(T, -1) @ mat.toarray().T,
                               rtol=1e-4, atol=1e-5)


def _dryrun_multiprocess(n_devices, n_processes, devices=None, workdir=None, timeout=600):
    """Start ``n_processes`` workers (``core/multihost_worker.py``) of
    ``n_devices // n_processes`` devices each over a small synthetic store
    made under ``workdir`` (default: a temporary directory; removed
    after); returns [(exit code, output)] of the workers, and raises when
    one failed or skipped a stage."""
    assert n_devices % n_processes == 0
    local = n_devices // n_processes
    kind = _mesh_devices(1, devices)[0].type
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    base = Path(workdir) if workdir is not None else Path(tempfile.mkdtemp(prefix="dryrun_store"))
    base.mkdir(parents=True, exist_ok=True)
    # worker output goes to files, not pipes: a worker blocked on a full
    # pipe mid-collective would hold up the whole group
    logs = [tempfile.TemporaryFile(mode="w+", encoding="utf-8") for _ in range(n_processes)]
    try:
        # X divisible by the x axis, T by the process-spanning t axis
        Cutout(base / "mh", device="cpu", module="synthetic", x=slice(-4, 1.76),
               y=slice(56, 60), time="2013-01-01").prepare(features=["wind"])
        store = base / "mh.atc"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "atlite_tpu_torch.core.multihost_worker", str(i),
             str(n_processes), str(port), str(store), kind, str(local)],
            stdout=logs[i], stderr=subprocess.STDOUT, env=env, cwd=root)
            for i in range(n_processes)]
        try:
            for p in procs:
                p.wait(timeout=timeout)
            results = []
            for i, (p, lf) in enumerate(zip(procs, logs)):
                lf.seek(0)
                out = lf.read()
                results.append((p.returncode, out))
                if p.returncode != 0:
                    raise RuntimeError(f"worker {i} failed (exit {p.returncode}):\n{out}")
                for stage in ("STEP OK", "AGG OK", "STORE OK", "PIPELINE OK", "MULTIHOST OK"):
                    if stage not in out:
                        raise RuntimeError(f"worker {i} did not reach {stage}:\n{out}")
            return results
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        for lf in logs:
            lf.close()
        shutil.rmtree(base, ignore_errors=True)
