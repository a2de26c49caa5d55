"""The fused kernel's launch on the host: the program's
``convert <t0>:<t1>`` spans around the C launch of the traced steps,
summed and divided by the steps, ms."""

from h100_bench.harness.spans import span_ms


def read(run):
    return span_ms(run, "step", "convert")
