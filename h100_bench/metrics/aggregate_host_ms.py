"""A convert call's aggregation on the host: the program's
``aggregate <t0>:<t1>`` spans (the matrix staged, the product, the
result brought to the host, the per-unit scaling) summed over the traced
convert calls and divided by them, ms."""

from h100_bench.harness.spans import span_ms


def read(run):
    return span_ms(run, "convert", "aggregate")
