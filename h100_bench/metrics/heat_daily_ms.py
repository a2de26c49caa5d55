"""The daily reduction of a heat-demand call: the program's
``aggregate <t0>:<t1>`` spans nested in a ``convert`` span (the day
grouping and the daily mean over the hours they fold) summed over the
traced ``heat_demand`` calls and divided by them, ms; None where the
program opened none."""

from h100_bench.harness import named


def read(run):
    daily = [nested for label, nested, _ in named.module("entries", "heat").aggregate_spans(run)
             if run.meta[label]["method"] == "heat_demand"]
    if not daily or not any(daily):
        return None
    return sum(daily) / 1e3 / len(daily)
