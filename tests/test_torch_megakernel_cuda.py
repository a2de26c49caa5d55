"""The fused CUDA kernel against its plain PyTorch version, on a card.

The kernel has no CPU mode, so these tests skip without a CUDA card.  They
import neither JAX nor the JAX package, so they also run on a machine that
has only PyTorch; there, skip this directory's conftest (which imports
JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_megakernel_cuda.py

Tolerance: max abs diff within 1e-5 * max|plain| per output (float32 sums
over the cells in another order than the plain matmul), NaN masks
identical.  Bus counts reach both of the kernel's bus tiles (20 buses a
pass up to B = 20, 36 above, so one pass up to B = 36) and cross them,
the power curve reaches the 256-knot limit, a 100 m hub makes the hub
speed equal the stored 100 m wind, so that queries fall exactly on the
curve's duplicated knots, and the roughness changes from hour to hour.
Cell counts take every residue mod 4, so that field rows start at every
16-byte phase (the kernel stages each row from the aligned address at or
below its first cell), and field bases are moved off their 16-byte
boundary.  One test holds the device memory of a step over a Cutout's
fields, which stages only the nine it reads.
"""

import numpy as np
import pytest
import torch

from atlite_tpu_torch import Cutout, build_inputs
from atlite_tpu_torch.entry import PANEL, step_fn
from atlite_tpu_torch.ops.megakernel import (
    FIELD_ORDER,
    Plan,
    knot_table,
    occupancy,
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


def assert_close(got, want, shape):
    """Kernel against plain: shape, identical NaN masks, max abs diff within
    1e-5 * max|plain|."""
    for g, w in zip(got, want):
        assert g.shape == shape and g.device.type == "cuda"
        g, w = g.cpu().double(), w.cpu().double()
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert float((g[ok] - w[ok]).abs().max()) <= 1e-5 * float(w[ok].abs().max())


def same_bits(a, b):
    """Equal bit for bit, NaN included."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(48, 16, 24, 5), (30, 7, 13, 3), (45, 9, 20, 37),
                                   (100, 12, 40, 70)])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    args = card_inputs(*shape, device=cuda_device)
    before = wind_pv_bus_megakernel.launches
    got = wind_pv_bus_megakernel(*args, PANEL)
    torch.cuda.synchronize()
    assert wind_pv_bus_megakernel.launches == before + 1
    assert_close(got, wind_pv_bus_plain(*args, PANEL), (shape[0], shape[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 20, 21, 24, 33, 34, 36, 37, 300, 2048])
def test_kernel_across_bus_tiles(cuda_device, B):
    """Every cell-hour's physics is computed once and multiplied by each
    bus tile; NaN cells poison only the buses they touch; a second call
    repeats the bits."""
    args = card_inputs(40, 8, 24, B, device=cuda_device, nan_cells=40)
    got = wind_pv_bus_megakernel(*args, PANEL)
    want = wind_pv_bus_plain(*args, PANEL)
    assert_close(got, want, (40, B))
    assert torch.isnan(got[0]).any() and not torch.isnan(got[0]).all()
    assert same_bits(wind_pv_bus_megakernel(*args, PANEL), got)


@pytest.mark.cuda
def test_one_pass_repeats_its_bits_on_ragged_cells(cuda_device):
    """B = 34 (PyPSA-Eur's countries) in one pass over C = 189 cells, which
    is no multiple of 4 (rows staged from the aligned address below their
    first cell and a padded copy of the matrix, as at PyPSA-Eur's 23,711
    cells); T = 3000 gives ~3 units a block, so the sums carry over units
    and items start inside a run; NaN cells poison only their buses; a
    second call repeats the bits."""
    T, Y, X, B = 3000, 9, 21, 34
    args = card_inputs(T, Y, X, B, device=cuda_device, nan_cells=12)
    got = wind_pv_bus_megakernel(*args, PANEL)
    assert_close(got, wind_pv_bus_plain(*args, PANEL), (T, B))
    assert torch.isnan(got[0]).any() and not torch.isnan(got[0]).all()
    assert same_bits(wind_pv_bus_megakernel(*args, PANEL), got)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [20, 34])
@pytest.mark.parametrize("Y, X", [(4, 48), (9, 21), (10, 19), (5, 43)])  # C % 4 = 0, 1, 2, 3
def test_every_row_phase_matches_plain_and_repeats(cuda_device, Y, X, B):
    """Both bus tiles over C of each residue mod 4, so that the rows of a
    unit start at every offset from a 16-byte boundary; the second call
    repeats the bits; each launch is counted by ``staged16``."""
    T = 600
    args = card_inputs(T, Y, X, B, device=cuda_device, nan_cells=12)
    before = wind_pv_bus_megakernel.staged16
    got = wind_pv_bus_megakernel(*args, PANEL)
    assert_close(got, wind_pv_bus_plain(*args, PANEL), (T, B))
    assert same_bits(wind_pv_bus_megakernel(*args, PANEL), got)
    assert wind_pv_bus_megakernel.staged16 - before == 2


@pytest.mark.cuda
@pytest.mark.parametrize("B", [20, 34])
def test_ragged_cells_equal_the_zero_padded_run(cuda_device, B):
    """C = 215 (3 mod 4) gives the bits of the same data zero-padded to 216
    cells with zero matrix columns there, whose rows all start aligned."""
    T, Y, X = 600, 5, 43
    flat, lat_cell, matrix, V, POWn = card_inputs(T, Y, X, B, device=cuda_device, nan_cells=12)
    pad = lambda a: torch.nn.functional.pad(a, (0, 1)).contiguous()
    got = wind_pv_bus_megakernel(flat, lat_cell, matrix, V, POWn, PANEL)
    padded = wind_pv_bus_megakernel({k: pad(v) for k, v in flat.items()}, pad(lat_cell),
                                    pad(matrix), V, POWn, PANEL)
    assert same_bits(got, padded)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["one", "all"])
def test_fields_off_their_16_byte_boundary(cuda_device, which):
    """Fields given as views one float past an allocation's start: one
    field alone (bases differ in their 16-byte phase: 4-byte copies, not
    counted by ``staged16``), or all nine (a common phase: 16-byte copies,
    row 0 read from the boundary below the base); the matrix likewise."""
    T, Y, X, B = 100, 9, 21, 34
    flat, lat_cell, matrix, V, POWn = card_inputs(T, Y, X, B, device=cuda_device)

    def shifted(a):
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
        view = buf[1:].view(a.shape)
        view.copy_(a)
        assert view.data_ptr() % 16 == 4 and view.is_contiguous()
        return view

    moved = {k: shifted(v) if which == "all" or k == FIELD_ORDER[3] else v
             for k, v in flat.items()}
    before = wind_pv_bus_megakernel.staged16
    got = wind_pv_bus_megakernel(moved, lat_cell, shifted(matrix), V, POWn, PANEL)
    assert wind_pv_bus_megakernel.staged16 - before == (which == "all")
    assert_close(got, wind_pv_bus_plain(flat, lat_cell, matrix, V, POWn, PANEL), (T, B))
    assert same_bits(got, wind_pv_bus_megakernel(flat, lat_cell, matrix, V, POWn, PANEL))


@pytest.mark.cuda
def test_staged16_counts_the_step_on_its_own_fields(cuda_device):
    """``entry.step_fn`` on (T, Y, X) fields that are each their own
    allocation, as a Cutout stages them, at a ragged C (17 x 23 cells):
    every launch stages by 16-byte copies."""
    fields, _, lon, lat, V, POWn, matrix = build_inputs(48, 17, 23, 34)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=cuda_device)
    args = ({k: put(fields[k]) for k in FIELD_ORDER}, None, put(lon), put(lat), put(V),
            put(POWn), put(matrix))
    step = step_fn()
    launches, before = wind_pv_bus_megakernel.launches, wind_pv_bus_megakernel.staged16
    for _ in range(3):
        step(*args)
    torch.cuda.synchronize()
    assert wind_pv_bus_megakernel.launches - launches == 3
    assert wind_pv_bus_megakernel.staged16 - before == 3


def step_inputs(device, T=48, Y=17, X=23, B=34):
    """The step's (T, Y, X) fields, lon, lat, V and POWn, and two (B, C)
    matrices, on the card: C = 17 x 23 (3 mod 4, as the year's 23,711
    cells), B = 34 as PyPSA-Eur's countries."""
    fields, _, lon, lat, V, POWn, matrix = build_inputs(T, Y, X, B)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)
    args = ({k: put(fields[k]) for k in FIELD_ORDER}, None, put(lon), put(lat), put(V), put(POWn))
    return args, (put(matrix), put(matrix[::-1]))


@pytest.mark.cuda
def test_step_reuses_its_plan_on_two_matrices(cuda_device):
    """N steps on fixed fields with two matrices in turn reuse the plan
    N - 1 times (``planned``) and launch N times; each answer equals a
    fresh step's bit for bit; a step's output is storage of its own, which
    the next step leaves as it was."""
    args, mats = step_inputs(cuda_device)
    step = step_fn()
    N = 6
    planned, launches = wind_pv_bus_megakernel.planned, wind_pv_bus_megakernel.launches
    outs = []
    for i in range(N):
        kept = [o.clone() for o in outs[-1]] if outs else None  # before the next step
        outs.append(step(*args, mats[i % 2]))
    torch.cuda.synchronize()
    assert wind_pv_bus_megakernel.planned - planned == N - 1
    assert wind_pv_bus_megakernel.launches - launches == N
    assert same_bits(outs[-2], kept)
    assert len({o[0].untyped_storage().data_ptr() for o in outs}) == N
    for i, out in enumerate(outs):
        assert same_bits(out, step_fn()(*args, mats[i % 2]))
    assert_close(outs[0], wind_pv_bus_plain(
        {k: v.reshape(48, -1) for k, v in args[0].items()}, args[3].repeat_interleave(23),
        mats[0], args[4], args[5], PANEL, 80.0), (48, 34))


@pytest.mark.cuda
def test_step_on_a_side_stream_builds_its_own_plan(cuda_device):
    """A step under another current stream builds a plan for that stream,
    then reuses it there, and builds again back on the default stream; the
    answers equal the default stream's bit for bit.  A plan refuses to
    launch under a stream it was not built for."""
    args, mats = step_inputs(cuda_device)
    step = step_fn()
    want = [step(*args, m) for m in mats]
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    before = wind_pv_bus_megakernel.planned
    with torch.cuda.stream(side):
        got = [step(*args, m) for m in mats]
    assert wind_pv_bus_megakernel.planned - before == 1
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    back = step(*args, mats[0])
    assert wind_pv_bus_megakernel.planned - before == 1
    torch.cuda.synchronize()
    assert all(same_bits(g, w) for g, w in zip(got, want)) and same_bits(back, want[0])
    flat = {k: v.reshape(48, -1) for k, v in args[0].items()}
    plan = Plan(flat, args[3].repeat_interleave(23), args[4], args[5], None, PANEL)
    with torch.cuda.stream(side), pytest.raises(ValueError, match="stream"):
        plan.launch(mats[0])


@pytest.mark.cuda
def test_occupancy_keeps_blocks_an_sm(cuda_device):
    """The padded field rows fit the shared memory of four narrow blocks
    (B <= 20) and three wide ones an SM."""
    dev = cuda_device.index or 0
    assert occupancy(dev, 20)[0] == 4
    assert occupancy(dev, 34)[0] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("B, passes", [(20, 1), (34, 1), (36, 1), (37, 2), (300, 9)])
def test_bus_passes_per_launch(cuda_device, B, passes):
    """``bus_passes`` adds ceil(B / bus tile) a launch: one pass up to 36
    buses, passes of 36 above."""
    args = card_inputs(16, 4, 16, B, device=cuda_device, nan_cells=0)
    launches, before = wind_pv_bus_megakernel.launches, wind_pv_bus_megakernel.bus_passes
    for _ in range(2):
        wind_pv_bus_megakernel(*args, PANEL)
    assert wind_pv_bus_megakernel.launches - launches == 2
    assert wind_pv_bus_megakernel.bus_passes - before == 2 * passes


@pytest.mark.cuda
def test_kernel_with_256_knots_and_a_100m_hub(cuda_device):
    """The widest knot table, and hub speeds exactly on duplicated knots:
    the wind field is set to the knots themselves, and a 100 m hub takes
    the stored 100 m wind unchanged."""
    flat, lat_cell, matrix, _, _ = card_inputs(48, 6, 20, 9, device=cuda_device, nan_cells=0)
    rng = np.random.default_rng(2)
    V = np.sort(rng.uniform(0.0, 30.0, 256)).astype(np.float32)
    V[[40, 200]] = V[[39, 199]]  # two jumps
    POWn = rng.random(256, dtype=np.float32)
    T, C = flat["wnd100m"].shape
    wnd = rng.choice(np.concatenate([V, V[[39, 199]].repeat(50)]), size=(T, C))
    flat["wnd100m"] = torch.as_tensor(wnd.astype(np.float32), device=cuda_device)
    V, POWn = (torch.as_tensor(a, device=cuda_device) for a in (V, POWn))
    for hub in (100.0, 80.0):
        got = wind_pv_bus_megakernel(flat, lat_cell, matrix, V, POWn, PANEL, hub_height=hub)
        want = wind_pv_bus_plain(flat, lat_cell, matrix, V, POWn, PANEL, hub_height=hub)
        assert_close(got, want, (T, 9))


@pytest.mark.cuda
def test_kernel_with_roughness_varying_by_hour(cuda_device):
    """Every cell-hour has its own roughness, so the two rows a thread
    computes (4 h apart) take different hub factors; ragged T and C."""
    T, Y, X, B = 45, 9, 20, 24
    flat, lat_cell, matrix, V, POWn = card_inputs(T, Y, X, B, device=cuda_device)
    rng = np.random.default_rng(5)
    z0 = flat["roughness"].cpu().numpy() * np.exp(0.5 * rng.standard_normal((T, Y * X)))
    assert (z0[4:] != z0[:-4]).all()
    flat["roughness"] = torch.as_tensor(z0.astype(np.float32), device=cuda_device)
    got = wind_pv_bus_megakernel(flat, lat_cell, matrix, V, POWn, PANEL)
    assert_close(got, wind_pv_bus_plain(flat, lat_cell, matrix, V, POWn, PANEL), (T, B))


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back(cuda_device):
    """Tensors split between the card and the CPU are refused, not moved."""
    flat, lat_cell, matrix, V, POWn = card_inputs(10, 3, 5, 2, device=cuda_device)
    with pytest.raises(ValueError, match="not on"):
        wind_pv_bus_megakernel(flat, lat_cell, matrix.cpu(), V, POWn, PANEL)
    with pytest.raises(ValueError, match="table"):
        wind_pv_bus_megakernel(flat, lat_cell, matrix, V, POWn, PANEL,
                               table=knot_table(V, POWn).cpu())


@pytest.mark.cuda
def test_step_stages_only_its_nine_fields(cuda_device):
    """A month (T = 744) of the benchmark's 14 time variables and height,
    C = 651 (≡ 3 mod 4, as the year's 23,711 cells): ``fields()`` stages
    nothing, and one ``entry.step_fn`` call stages the nine fields it reads
    and allocates nothing but its buffers, which the same step over fields
    staged up front with ``_put`` shows; a second call stages nothing.
    The (wind, PV) pair equals that step's bit for bit."""
    c = Cutout(device=cuda_device, module="synthetic", x=slice(-4, 3.5), y=slice(50, 55),
               time="2013-01").prepare(
        features=["wind", "influx", "temperature", "runoff", "height"])
    del c.data["wnd10m"]  # not a variable of the benchmark's set
    T, (Y, X) = len(c.grid_desc.time), c.shape
    assert (T, Y * X % 4, len(c.data)) == (744, 3, 15)
    _, _, _, _, V, POWn, matrix = build_inputs(16, Y, X, 34)
    put = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=cuda_device)
    lat, V, POWn, matrix = put(c.grid_desc.y), put(V), put(POWn), put(matrix)

    def peak_of(fields):
        """(wind, PV) of a fresh step, and the bytes allocated above what
        was allocated before ``fields()``, at their peak; every block from
        a fresh segment, as the allocator counts it."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cuda_device)
        base = torch.cuda.memory_allocated(cuda_device)
        out = step_fn()(fields(), None, None, lat, V, POWn, matrix)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated(cuda_device) - base

    eager = {n: c._put(a, c.dtype) for n, a in c.data.items()}
    want, buffers = peak_of(lambda: eager)
    v0, b0 = Cutout.staged_variables, Cutout.staged_bytes
    got, peak = peak_of(c.fields)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(cuda_device)
    one = torch.empty((T, Y, X), device=cuda_device)
    field = torch.cuda.memory_allocated(cuda_device) - before  # as the allocator counts it
    del one
    assert 9 * field <= peak <= 9 * field + buffers
    assert Cutout.staged_variables - v0 == 9
    assert Cutout.staged_bytes - b0 == 9 * T * Y * X * 4
    fields = c.fields()
    assert set(dict.keys(fields)) == set(FIELD_ORDER) and len(fields) == 19
    assert same_bits(got, want)
    again = step_fn()(fields, None, None, lat, V, POWn, matrix)
    assert Cutout.staged_variables - v0 == 9 and same_bits(again, want)
