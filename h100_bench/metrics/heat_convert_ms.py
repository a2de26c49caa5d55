"""A heat call's converter on the host: the program's
``convert <t0>:<t1>`` spans (the eager chain's enqueue, the daily
reduction and the uploads inside it included) summed over the traced
heat calls and divided by them, ms."""

from h100_bench.harness.spans import span_ms


def read(run):
    return span_ms(run, "heat", "convert")
