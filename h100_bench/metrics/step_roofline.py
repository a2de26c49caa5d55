"""The fused step's kernels against their byte bound: 100 x the bound /
their device time, from the trace.  A step reads the 9 fields of
``FIELD_ORDER`` once and the (B, C) float32 matrix once, and writes the
two (T, B) float32 series once, at the card's published bandwidth."""

from h100_bench.harness.peaks import hbm_bytes_per_s

N_FIELDS = 9
# the kernels of atlite_tpu_torch/ops/csrc/megakernel.cu
KERNELS = r"panel_kernel|wind_pv_bus_kernel|sum_items_kernel"


def step_bytes(meta):
    T, C, B = meta["T"], meta["C"], meta["B"]
    return 4 * (N_FIELDS * T * C + B * C + 2 * T * B)


def read(run):
    peak = hbm_bytes_per_s(run.device_kind)
    if run.trace is None or peak is None:
        return None
    steps = [label for _, _, label in run.trace.calls if run.meta[label]["entry"] == "step"]
    kernel_us = run.trace.device_time(KERNELS)
    if not steps or kernel_us <= 0:
        return None
    bound_s = sum(step_bytes(run.meta[label]) for label in steps) / peak
    return 100.0 * bound_s / (kernel_us / 1e6)
