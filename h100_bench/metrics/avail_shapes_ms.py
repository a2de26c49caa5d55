"""The windows' work of an availability call: the program's
``aggregate <s0>:<s1>`` spans (a batch of shapes' windows rasterized,
masked, dilated and counted per cell) summed over the traced avail calls
and divided by them, ms."""

from h100_bench.harness.spans import span_ms


def read(run):
    return span_ms(run, "avail", "aggregate")
