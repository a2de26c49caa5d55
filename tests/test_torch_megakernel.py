"""The port's fused-step wrapper.

On CPU tensors the wrapper runs its plain version; it is held against the
JAX package's Pallas kernel (interpret mode) on NaN-free inputs at
atol 2e-5, as tests/test_megakernel.py holds that kernel, and against
``__graft_entry__._step_fn`` (whose sparse NaN rule the port follows)
with NaN cells, where the NaN masks must be equal.  JAX runs with x64 off,
as on its chip.  The kernel itself runs only on a CUDA card; its test is
tests/test_torch_megakernel_cuda.py.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from atlite_tpu.ops.megakernel import wind_pv_bus_megakernel as pallas_megakernel
from atlite_tpu_torch import build_inputs
from atlite_tpu_torch.entry import PANEL
from atlite_tpu_torch.ops.megakernel import (
    FIELD_ORDER,
    MAX_KNOTS,
    wind_pv_bus_megakernel,
)

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
    wind_pv_bus_megakernel.launches = 0
    wb, pb = wind_pv_bus_megakernel(*to_torch(flat, lat_cell, matrix, V, POWn), PANEL)
    assert wind_pv_bus_megakernel.launches == 0  # the CPU path launches nothing
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
