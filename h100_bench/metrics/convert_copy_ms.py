"""A convert call's uploads: the program's ``copy <t0>:<t1>`` spans (the
matrix staged, the power curve, the coordinates), nested in its convert
and aggregate spans, summed over the traced convert calls and divided by
them, ms."""

from h100_bench.harness.spans import span_ms


def read(run):
    return span_ms(run, "convert", "copy")
