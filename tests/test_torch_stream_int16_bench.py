"""The benchmark's ``stream`` entry (cell ``eur03-stream-int16``) at a
small size on the CPU: 32 x 64 cells of the configuration's 0.3 deg
lattice, 96 h in 24 h chunks, 512 regions, with the dense limit lowered
so that every chunk takes the banded aggregation route.

Held: the port's streamed int16 onwind and solar against the entry's
packed float64 reference, within its limit, traced and untraced; the two
planted faults of ``h100_bench/stream_control.py`` (a stale window,
swapped pack parameters) and the bfloat16 reference judged not correct;
``reference/pack16.py``'s codes equal to ``Cutout._pack``'s bit for bit,
and its rebuilt values to ``Cutout._unpack``'s within float32 rounding;
the reference modules import neither JAX nor the JAX package nor the
port.
"""

import ast
import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from atlite_tpu_torch import Cutout, aggregate  # noqa: E402
from atlite_tpu_torch.core.grid import Grid  # noqa: E402
from atlite_tpu_torch.ops import bsr_spmm  # noqa: E402
from h100_bench import stream_control  # noqa: E402
from h100_bench.harness import bench, check  # noqa: E402
from h100_bench.harness import cutout as harness_cutout  # noqa: E402
from h100_bench.harness.session import Session  # noqa: E402
from h100_bench.reference import pack16  # noqa: E402

CELL = "eur03-stream-int16"
SEED = 2**31 + 99
START = np.datetime64("2013-06-01T00", "ns")
HOURS, CHUNK = 96, 24


@pytest.fixture
def cell(monkeypatch):
    """(cell, small config, traffic, e2e, per-layer) of the cell, its hours
    cut to 96 and the dense limit lowered; counts the banded products."""
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    c, config, traffic, e2e, layer = bench.resolve(CELL, spec)
    config = copy.deepcopy(config)
    config["cutout"].update(x=[-12.0, 6.9], y=[33.0, 42.3])
    config["regions"].update(ny=16, nx=32)
    traffic = dict(traffic, call_kwargs=dict(traffic["call_kwargs"], time_chunk=CHUNK))
    monkeypatch.setattr(harness_cutout, "hours_of",
                        lambda period: START + np.arange(HOURS) * np.timedelta64(1, "h"))
    monkeypatch.setattr(aggregate, "_DENSE_LIMIT", 1 << 16)
    banded = bsr_spmm.banded_spmm
    products = []

    def counted(*args, **kwargs):
        products.append(1)
        return banded(*args, **kwargs)
    monkeypatch.setattr(bsr_spmm, "banded_spmm", counted)
    return (c, config, traffic, e2e, layer), products


def run(cell, trace=0):
    return bench.run_cell(*cell, SEED, 0.3, trace, "cpu")


def test_the_cell_is_found_as_the_traffic_asks(cell):
    (c, config, traffic, e2e, layer), _ = cell
    assert c["config"] == "pypsa-eur-2013-0.3deg-stream-int16" and c["chips"] == 1
    assert traffic["entry"] == "stream" and traffic["technologies"] == ["onwind", "solar"]
    assert traffic["call_kwargs"]["stream_pack"] == "int16"
    assert {m["name"] for m in e2e} == {"setup_s", "device_peak_gb"}
    assert {m["name"] for m in layer} == {"stream_call_ms", "stream_pack_ms", "stream_wait_ms",
                                          "stream_h2d_gb", "idle_share.stream",
                                          "stream_roofline"}
    assert all(m["workloads"] == [CELL] for m in layer)
    assert {m["name"] for m in layer if m["moves"] == "device_peak_gb"} == {"stream_h2d_gb"}


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(cell, trace):
    cell, products = cell
    result, checks = run(cell, trace)
    assert result["correct"], checks
    values = {name: value for name, value, _ in checks}
    assert set(values) == {"rel_l2.onwind", "rel_l2.solar", "nan_mismatch", "unchecked",
                           "failed_calls"}
    assert result["attempted"] >= 2 and result["failed"] == 0
    # every chunk of every call (the two warm calls, the window's, the
    # traced stretch's) went through the banded product
    calls, rest = divmod(len(products), HOURS // CHUNK)
    assert rest == 0 and (calls >= result["attempted"] + 2 if trace
                          else calls == result["attempted"] + 2)
    if trace:
        m = {k: v["value"] for k, v in result["metrics"].items()}
        assert m["stream_pack_ms"] > 0 and m["stream_wait_ms"] >= 0 and m["stream_call_ms"] > 0
        # a call moves its fields' codes, 96 h of 2048 cells at 2 B: onwind
        # 2 fields, solar 7; the calls run in turn from onwind, so the mean
        # is over k of each, or one onwind more
        code = HOURS * 2048 * 2 / 1e9
        means = [(n * 2 + k * 7) * code / (n + k) for k in range(1, 10**4) for n in (k, k + 1)]
        assert min(abs(m["stream_h2d_gb"] - v) for v in means) < 1e-15
    else:
        assert set(result["metrics"]) == {"setup_s"}


@pytest.mark.parametrize("fault", sorted(stream_control.FAULTS))
def test_planted_fault_is_not_correct(cell, fault):
    cell, _ = cell
    with stream_control.FAULTS[fault](START):
        result, checks = run(cell)
    assert not result["correct"], checks


def test_the_bfloat16_reference_fails_a_number(cell):
    (_, config, traffic, _, _), _ = cell
    session = Session(config, traffic, SEED, "cpu")
    gaps = check.control(session, torch.device("cpu"))
    assert any(gap > session.entry.limit(session, label) for label, gap in gaps.items()), gaps


# ---------------------------------------------------------------- pack16
def seeded_year(seed, shape=(40, 6, 7)):
    """{name: float32 (T, Y, X)}: a linear variable with NaNs, a positive
    one spanning five decades (log space), one whose values sit on its
    range's ends, a constant one and one all NaN."""
    rng = np.random.default_rng(seed)
    lin = rng.normal(10.0, 4.0, shape).astype(np.float32)
    lin[rng.random(shape) < 0.05] = np.nan
    rough = np.exp(rng.uniform(np.log(2e-4), np.log(20.0), shape)).astype(np.float32)
    ends = rng.uniform(-3.5, 7.25, shape).astype(np.float32)
    pick = rng.random(shape)
    ends[pick < 0.2], ends[pick > 0.8] = -3.5, 7.25
    return {"lin": lin, "rough": rough, "ends": ends,
            "flat": np.full(shape, 3.0, np.float32), "void": np.full(shape, np.nan, np.float32)}


def seeded_cutout(data):
    T, Y, X = next(iter(data.values())).shape
    grid = Grid(x=np.arange(X) * 0.25, y=50.0 + np.arange(Y) * 0.25,
                time=START + np.arange(T) * np.timedelta64(1, "h"), crs=4326)
    return Cutout(data=data, grid_desc=grid, attrs={"module": "era5", "dx": 0.25, "dy": 0.25},
                  device="cpu")


# the program's pack_params takes nanmin/nanmax of the all-NaN variable
@pytest.mark.filterwarnings("ignore:All-NaN slice encountered:RuntimeWarning")
@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7])
def test_pack16_codes_equal_the_programs(seed):
    data = seeded_year(seed)
    cut = seeded_cutout(data)
    params = cut.pack_params(list(data))
    sub = cut.isel_time(5, 33, pack16=params)
    batch = sub._pack(np.dtype("float32"))
    assert batch["names"] == list(data)
    codes = batch["host"].numpy().view(np.uint16)
    for i, name in enumerate(batch["names"]):
        p = pack16.params(torch.from_numpy(data[name]))
        assert p == params[name]
        assert p[2] == (name == "rough")
        want = pack16.codes(torch.from_numpy(data[name][5:33]), p).numpy()
        np.testing.assert_array_equal(codes[i].astype(np.int64), want)
    assert codes[list(data).index("void")].min() == pack16.NAN_CODE
    ends = codes[list(data).index("ends")]
    assert ends.min() == 0 and ends.max() == pack16.TOP


@pytest.mark.filterwarnings("ignore:All-NaN slice encountered:RuntimeWarning")
@pytest.mark.parametrize("seed", [0, 1])
def test_pack16_rebuilds_what_the_program_unpacks(seed):
    data = seeded_year(seed)
    cut = seeded_cutout(data)
    sub = cut.isel_time(0, 40, pack16=cut.pack_params(list(data)))
    batch = sub._pack(np.dtype("float32"))
    fields = sub._unpack(batch, batch["host"], np.dtype("float32"))
    for name, p in zip(batch["names"], batch["params"]):
        want = pack16.quantized(torch.from_numpy(data[name]), p).numpy()
        got = fields[name].numpy().astype(np.float64)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=2e-6, atol=1e-6)


REFERENCE = CHECKOUT / "h100_bench" / "reference"
FORBIDDEN = ("jax", "jaxlib", "atlite_tpu", "atlite_tpu_torch")


@pytest.mark.parametrize("name", ["pack16", "physics", "wind", "pv"])
def test_the_reference_imports_no_jax_and_no_program(name):
    tree = ast.parse((REFERENCE / f"{name}.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m for m in imported if m.split(".")[0] in FORBIDDEN}, imported
    probe = (f"import sys; sys.path.insert(0, {str(CHECKOUT)!r}); "
             f"import h100_bench.reference.{name}; "
             f"print(sorted({{m.split('.')[0] for m in sys.modules}} & {set(FORBIDDEN)!r}))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out
