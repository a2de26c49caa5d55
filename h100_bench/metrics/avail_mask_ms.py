"""The host's mask builds of an availability call: the program's
``mask <b0>:<b1>`` spans on any thread (the build runs on a worker) that
lie inside a traced avail call, summed and divided by the traced calls,
ms; 0 where the program built none on the host."""

import re

MASK = re.compile(r"^mask \d+:\d+$")


def read(run):
    if run.trace is None:
        return None
    calls = [(a, b) for a, b, label in run.trace.calls if run.meta[label]["entry"] == "avail"]
    if not calls:
        return None
    total = sum(min(b, hi) - max(a, lo) for a, b, name, _ in run.trace.host
                if MASK.match(name) for lo, hi in calls if b > lo and a < hi)
    return total / 1e3 / len(calls)
