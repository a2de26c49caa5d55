"""A heat call's aggregation to regions: the program's top-level
``aggregate <t0>:<t1>`` spans (outside every ``convert`` span: the matrix
staged, the product, the result to the host, the per-unit scaling)
summed over the traced heat calls and divided by them, ms; None where
the program opened none."""

from h100_bench.harness import named


def read(run):
    calls = named.module("entries", "heat").aggregate_spans(run)
    if not calls or not any(top for _, _, top in calls):
        return None
    return sum(top for _, _, top in calls) / 1e3 / len(calls)
