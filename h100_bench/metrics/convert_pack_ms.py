"""A convert call's host preparation: the program's ``pack <t0>:<t1>``
spans (the technology lookup in ``wind``/``pv``, the matrix composition
in ``convert_and_aggregate``) summed over the traced convert calls and
divided by them, ms."""

from h100_bench.harness.spans import span_ms


def read(run):
    return span_ms(run, "convert", "pack")
