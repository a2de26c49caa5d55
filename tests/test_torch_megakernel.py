"""The port's fused-step wrapper.

On CPU tensors the wrapper runs its plain version; it is held against the
JAX package's Pallas kernel (interpret mode) on NaN-free inputs at
atol 2e-5, as tests/test_megakernel.py holds that kernel, and against
``__graft_entry__._step_fn`` (whose sparse NaN rule the port follows)
with NaN cells, where the NaN masks must be equal.  JAX runs with x64 off,
as on its chip.  The kernel itself runs only on a CUDA card; its test is
tests/test_torch_megakernel_cuda.py.  What the wrapper hands the kernel is
held here: the power-curve table, read by a torch emulation of the
kernel's upper-bound search, against both packages' power curves, and the
persistent grid's work split.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from atlite_tpu.ops.megakernel import wind_pv_bus_megakernel as pallas_megakernel
from atlite_tpu.physics import wind as jax_wind
from atlite_tpu_torch import build_inputs, from_jax_inputs
from atlite_tpu_torch.entry import PANEL, step_fn
from atlite_tpu_torch.ops.megakernel import (
    FIELD_ORDER,
    MAX_KNOTS,
    Plan,
    UNIT_CELLS,
    UNIT_ROWS,
    knot_table,
    wind_pv_bus_megakernel,
    work_split,
)
from atlite_tpu_torch.physics import wind

torch.set_num_threads(1)

JAX_PANEL = dict(k_1=-0.017162, k_2=-0.040289, k_3=-0.004681, k_4=0.000148,
                 k_5=0.000169, k_6=0.000005, c_temp_irrad=0.035, c_temp_amb=1.0,
                 r_tmod=298.0, r_irradiance=1000.0, inverter_efficiency=0.9)


def flat_inputs(T, Y, X, B, nan_cells=0):
    """numpy (flat fields, lat_cell, matrix, V, POWn) and the (T, Y, X)
    fields, by the bench recipe; optionally with NaN wind cells."""
    fields, eph, lon, lat, V, POWn, matrix = build_inputs(T, Y, X, B)
    if nan_cells:
        rng = np.random.default_rng(11)
        idx = tuple(rng.integers(0, n, nan_cells) for n in (T, Y, X))
        fields["wnd100m"][idx] = np.nan
    flat = {k: v.reshape(T, -1) for k, v in fields.items() if v.ndim == 3}
    return flat, np.repeat(lat, X), matrix, V, POWn, (fields, eph, lon, lat)


def to_torch(flat, lat_cell, matrix, V, POWn, device="cpu"):
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)
    return {k: put(flat[k]) for k in FIELD_ORDER}, put(lat_cell), put(matrix), put(V), put(POWn)


@pytest.mark.parametrize("shape", [(48, 16, 24, 5), (30, 7, 13, 3), (10, 3, 5, 2)])
def test_plain_matches_pallas_kernel(shape):
    flat, lat_cell, matrix, V, POWn, _ = flat_inputs(*shape)
    wind_pv_bus_megakernel.launches = wind_pv_bus_megakernel.bus_passes = 0
    wb, pb = wind_pv_bus_megakernel(*to_torch(flat, lat_cell, matrix, V, POWn), PANEL)
    # the CPU path launches nothing and makes no pass over the buses
    assert wind_pv_bus_megakernel.launches == wind_pv_bus_megakernel.bus_passes == 0
    with jax.enable_x64(False):
        rw, rp = pallas_megakernel(flat, lat_cell, matrix, V, POWn, JAX_PANEL,
                                   interpret=True)
    T, B = shape[0], shape[3]
    assert wb.shape == (T, B) and pb.shape == (T, B)
    np.testing.assert_allclose(wb.numpy(), np.asarray(rw), atol=2e-5)
    np.testing.assert_allclose(pb.numpy(), np.asarray(rp), atol=2e-5)


@pytest.mark.parametrize("shape", [(24, 16, 32, 4), (30, 7, 13, 3)])
def test_plain_matches_step_with_nan_cells(shape):
    """Sparse NaN rule: a NaN wind cell poisons only the buses whose row
    touches it (the Pallas kernel would poison every bus)."""
    flat, lat_cell, matrix, V, POWn, (fields, eph, lon, lat) = flat_inputs(*shape, nan_cells=6)
    wb, pb = wind_pv_bus_megakernel(*to_torch(flat, lat_cell, matrix, V, POWn), PANEL)
    with jax.enable_x64(False):
        rw, rp = jax.jit(ge._step_fn())(fields, eph, lon, lat, V, POWn, matrix)
    rw, rp = np.asarray(rw), np.asarray(rp)
    assert np.isnan(rw).any() and not np.isnan(rw).all()
    np.testing.assert_array_equal(np.isnan(wb.numpy()), np.isnan(rw))
    np.testing.assert_allclose(wb.numpy(), rw, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(pb.numpy(), rp, rtol=1e-5, atol=2e-5)


def valid_args():
    return to_torch(*flat_inputs(6, 3, 4, 2)[:5])


def test_wrapper_raises_on_wrong_dtype():
    fields, lat_cell, matrix, V, POWn = valid_args()
    fields["albedo"] = fields["albedo"].double()
    with pytest.raises(TypeError, match="float32"):
        wind_pv_bus_megakernel(fields, lat_cell, matrix, V, POWn, PANEL)


def test_wrapper_raises_on_wrong_device():
    fields, lat_cell, matrix, V, POWn = valid_args()
    with pytest.raises(ValueError, match="not on"):
        wind_pv_bus_megakernel(fields, lat_cell, matrix.to("meta"), V, POWn, PANEL)
    meta = {k: v.to("meta") for k, v in fields.items()}
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        wind_pv_bus_megakernel(meta, lat_cell.to("meta"), matrix.to("meta"),
                               V.to("meta"), POWn.to("meta"), PANEL)


def test_wrapper_raises_on_too_many_knots():
    fields, lat_cell, matrix, _, _ = valid_args()
    V = torch.linspace(0.0, 30.0, MAX_KNOTS + 1)
    with pytest.raises(ValueError, match="knots"):
        wind_pv_bus_megakernel(fields, lat_cell, matrix, V, torch.ones_like(V), PANEL)


def test_wrapper_raises_on_shape_and_layout():
    fields, lat_cell, matrix, V, POWn = valid_args()
    with pytest.raises(ValueError, match="lat_cell"):
        wind_pv_bus_megakernel(fields, lat_cell[:-1], matrix, V, POWn, PANEL)
    with pytest.raises(ValueError, match="matrix"):
        wind_pv_bus_megakernel(fields, lat_cell, matrix[:, :-1].contiguous(), V, POWn,
                               PANEL)
    with pytest.raises(ValueError, match="contiguous"):
        wind_pv_bus_megakernel({**fields, "temperature": fields["temperature"].T.contiguous().T},
                               lat_cell, matrix, V, POWn, PANEL)
    with pytest.raises(KeyError, match="roughness"):
        wind_pv_bus_megakernel({k: v for k, v in fields.items() if k != "roughness"},
                               lat_cell, matrix, V, POWn, PANEL)
    with pytest.raises(ValueError, match="Huld"):
        wind_pv_bus_megakernel(fields, lat_cell, matrix, V, POWn,
                               {**PANEL, "model": "bofinger"})


def step_args(T=12, Y=5, X=7, B=3):
    """CPU tensors of the headline step's arguments, by the bench recipe."""
    return list(from_jax_inputs(*build_inputs(T, Y, X, B), device="cpu"))


def same_bits(a, b):
    """Equal bit for bit, NaN included."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def write_field(args):
    args[0]["temperature"].add_(1.5)


def replace_field(args):
    args[0]["albedo"] = args[0]["albedo"] * 0.5


def write_lat(args):
    args[3].add_(2.0)


def replace_V(args):
    args[4] = args[4] + 0.5


@pytest.mark.parametrize("change, rebuilt", [(None, False), (write_field, True),
                                             (replace_field, True), (write_lat, True),
                                             (replace_V, True)])
def test_step_keeps_its_plan_until_an_input_changes(change, rebuilt):
    """``step_fn`` keeps its launch plan while it is given the same fields,
    ``lat``, ``V`` and ``POWn``: two matrices in turn reuse it after the
    first call (``planned`` counts each reuse); a field or ``lat`` written
    in place, or a field or ``V`` replaced by another tensor, builds it
    again.  Every answer equals a fresh step's bit for bit."""
    args = step_args()
    m1 = args[6]
    m2 = torch.flip(m1, (0,)).contiguous()
    step = step_fn()
    for i, m in enumerate((m1, m2, m1, m2)):
        before = wind_pv_bus_megakernel.planned
        got = step(*args[:6], m)
        assert wind_pv_bus_megakernel.planned - before == (i > 0)
        assert same_bits(got, step_fn()(*args[:6], m))
    if change is not None:
        change(args)
    before = wind_pv_bus_megakernel.planned
    got = step(*args[:6], m1)
    assert wind_pv_bus_megakernel.planned - before == (not rebuilt)
    assert same_bits(got, step_fn()(*args[:6], m1))
    before = wind_pv_bus_megakernel.planned
    assert same_bits(step(*args[:6], m2), step_fn()(*args[:6], m2))
    assert wind_pv_bus_megakernel.planned - before == 1


@pytest.mark.parametrize("bad, error, match", [
    (lambda m: m.double(), TypeError, "float32"),
    (lambda m: m.numpy(), TypeError, "torch.Tensor"),
    (lambda m: m[:, :-1].contiguous(), ValueError, "matrix"),
    (lambda m: m.T.contiguous().T, ValueError, "contiguous"),
    (lambda m: m.to("meta"), ValueError, "not on"),
])
def test_step_checks_the_matrix_on_a_kept_plan(bad, error, match):
    """A matrix the kernel does not take raises as the wrapper does, also
    after a valid call, when the plan is reused; the plan stays usable."""
    args = step_args()
    step = step_fn()
    want = step(*args)
    with pytest.raises(error, match=match):
        step(*args[:6], bad(args[6]))
    before = wind_pv_bus_megakernel.planned
    assert same_bits(step(*args), want)
    assert wind_pv_bus_megakernel.planned - before == 1


def test_wrapper_refuses_a_plan_of_other_inputs():
    """A plan given to the wrapper must have been built from the very
    tensors, panel and hub height it is given with."""
    fields, lat_cell, matrix, V, POWn = valid_args()
    plan = Plan(fields, lat_cell, V, POWn, None, PANEL)
    want = wind_pv_bus_megakernel(fields, lat_cell, matrix, V, POWn, PANEL)
    assert same_bits(wind_pv_bus_megakernel(fields, lat_cell, matrix, V, POWn, PANEL,
                                            plan=plan), want)
    with pytest.raises(ValueError, match="other inputs"):
        wind_pv_bus_megakernel(fields, lat_cell, matrix, V.clone(), POWn, PANEL, plan=plan)
    with pytest.raises(ValueError, match="other inputs"):
        wind_pv_bus_megakernel(fields, lat_cell, matrix, V, POWn, PANEL, hub_height=100.0,
                               plan=plan)


def test_step_in_inference_mode_builds_every_call():
    """Tensors made in inference mode keep no version, so the step cannot
    tell whether they were written: it builds its plan at every call."""
    with torch.inference_mode():
        args = step_args()
        step = step_fn()
        before = wind_pv_bus_megakernel.planned
        first, second = step(*args), step(*args)
    assert wind_pv_bus_megakernel.planned == before
    assert same_bits(first, second)


def searched_curve(table, n_knots, x):
    """torch emulation of the kernel's power curve: the branch-free
    upper-bound search over the table's column 0, then the segment's value
    or the clamped end value, in the kernel's order of operations."""
    P = table.shape[0]
    keys, power, slope = table[:, 0], table[:, 1], table[:, 2]
    pos = torch.zeros(x.shape, dtype=torch.long)
    step = P // 2
    while step:
        pos += torch.where(keys[pos + step - 1] <= x, step, 0)
        step //= 2
    pos += (keys[pos] <= x).long()
    k = pos - 1
    kk = k.clamp(0, n_knots - 2)
    inside = 0.0 + (power[kk] + (x - keys[kk]) * slope[kk])
    out = torch.where(k < 0, (0.0 + 0.0) + power[0],
                      torch.where(k >= n_knots - 1, (0.0 + 0.0) + power[n_knots - 1], inside))
    return torch.where(torch.isnan(x), torch.nan, out)


def curve_cases():
    """(V, POWn) power curves: the bench curve (duplicated cut-out knot),
    a curve with duplicated cut-in and cut-out knots, K = 2 and K = 256."""
    _, _, _, _, V, POWn, _ = build_inputs(2, 2, 2, 1)
    jumps = (np.array([0.0, 3.0, 3.0, 7.5, 12.0, 25.0, 25.0, 30.0], dtype=np.float32),
             np.array([0.0, 0.0, 0.05, 0.4, 1.0, 1.0, 0.0, 0.0], dtype=np.float32))
    two = (np.array([2.0, 20.0], dtype=np.float32), np.array([0.0, 1.0], dtype=np.float32))
    rng = np.random.default_rng(4)
    v256 = np.sort(rng.uniform(0.0, 40.0, MAX_KNOTS)).astype(np.float32)
    v256[100] = v256[99]  # one jump inside
    wide = (v256, rng.random(MAX_KNOTS, dtype=np.float32))
    return {"bench": (V, POWn), "jumps": jumps, "K=2": two, "K=256": wide}


@pytest.mark.parametrize("case", ["bench", "jumps", "K=2", "K=256"])
def test_knot_table_search_matches_power_curves(case):
    V, POWn = curve_cases()[case]
    K = len(V)
    rng = np.random.default_rng(K)
    x = np.concatenate([
        V,                                           # exactly on every knot
        np.nextafter(V, np.float32(-np.inf)), np.nextafter(V, np.float32(np.inf)),
        [V[0] - 1.0, V[0] - 1e-3, V[-1], V[-1] + 1e-3, V[-1] + 50.0],
        [np.nan, np.inf, -np.inf],
        rng.uniform(V[0] - 2.0, V[-1] + 2.0, 2000),
    ]).astype(np.float32)
    Vt, Pt, xt = (torch.as_tensor(a) for a in (V, POWn, x))
    table = knot_table(Vt, Pt)
    P = table.shape[0]
    assert P >= K and P & (P - 1) == 0 and P < 2 * K
    assert torch.isinf(table[K:, 0]).all() and (table[K - 1:, 2] == 0).all()
    got = searched_curve(table, K, xt)
    # the port's plain power curve: the same bits, NaN included
    want = wind.power_curve(xt, Vt, Pt, 1.0)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])
    # a query exactly on a duplicated knot takes the post-jump segment
    dup = np.flatnonzero(np.diff(V) == 0)
    for d in dup:
        on = torch.tensor([V[d]])
        assert float(searched_curve(table, K, on)) == float(POWn[d + 1])
    # and the JAX package's power curve within float32 rounding
    with jax.enable_x64(False):
        ref = np.asarray(jax_wind.power_curve(x, V, POWn, 1.0))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T, C, n_blocks", [
    (2184, 96 * 128, 132 * 3), (2184, 96 * 128, 132 * 2), (30, 91, 132 * 3),
    (45, 180, 7), (1, 1, 264), (17, 130, 3), (100, 480, 40)])
def test_work_split_covers_every_unit_once(T, C, n_blocks):
    s = work_split(T, C, n_blocks)
    n_tt, n_cb = -(-T // UNIT_ROWS), -(-C // UNIT_CELLS)
    U = n_tt * n_cb
    bu, bi, ti, st = s["block_unit"], s["block_item"], s["tile_item"], s["item_start"]
    N = len(bu) - 1
    assert N == min(n_blocks, U)
    assert bu[0] == 0 and bu[-1] == U
    runs = np.diff(bu)
    assert runs.min() >= 1 and runs.max() - runs.min() <= 1  # balanced to a unit
    # items tile the units in order, each inside one time tile
    assert st[0] == 0 and st[-1] == U and (np.diff(st) > 0).all()
    covered = np.zeros((n_tt, n_cb), dtype=int)
    for i in range(len(st) - 1):
        tiles = np.arange(st[i], st[i + 1]) // n_cb
        assert (tiles == tiles[0]).all()
        covered.reshape(-1)[st[i]:st[i + 1]] += 1
    assert (covered == 1).all()
    # a block's items: its first is block_item[k], the next ones start at
    # each time tile's first chunk, and they end where its run ends
    for k in range(N):
        i = bi[k]
        assert st[i] == bu[k]
        for u in range(bu[k] + 1, bu[k + 1]):
            if u % n_cb == 0:
                i += 1
                assert st[i] == u
        assert st[i + 1] == bu[k + 1]
    # the partial sums of tile t are items tile_item[t] .. tile_item[t+1]-1
    assert len(ti) == n_tt + 1 and ti[0] == 0 and ti[-1] == len(st) - 1
    for t in range(n_tt):
        assert st[ti[t]] == t * n_cb and st[ti[t + 1]] == (t + 1) * n_cb
    # partials: (2, n_items, 8, B), at most one item a block and a tile
    assert len(st) - 1 <= N + n_tt
