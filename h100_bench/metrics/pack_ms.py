"""The streamer's host packing a call: the ``pack <t0>:<t1>`` ranges of
``convert._Stager`` (its worker thread), summed over the traced stretch
and divided by its calls."""

import re

PACK = re.compile(r"^pack \d+:\d+$")


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    lo, hi = run.trace.stretch
    total = sum(b - a for a, b, name, _ in run.trace.host
                if PACK.match(name) and a >= lo and b <= hi)
    return total / 1e3 / len(run.trace.calls) if total > 0 else None
