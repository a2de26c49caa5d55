"""``entry.step_fn``'s argument building on the host: the program's
``pack <t0>:<t1>`` spans (the step's flattening, latitudes and knot
table; the kernel's checks, grid, buffers and C arguments) summed over
the traced steps and divided by them, ms."""

from h100_bench.harness.spans import span_ms


def read(run):
    return span_ms(run, "step", "pack")
