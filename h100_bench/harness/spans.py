"""The program's own spans and the runtime's launches inside the traced
calls of one entry: the host events on the calling thread of each call,
inside that call's ``bench:call`` range.

A span is a range that the program opens, named ``"<step> <t0>:<t1>"``
(``trace.RANGE`` without the harness's ``bench:``).  A reader returns
None without a trace, without a call of the entry, or, for a span, where
the program opened none (a program without spans).  How much of a call
the spans cover is no metric: a span that shrinks would read as a loss."""

from __future__ import annotations

import bisect
import re

from h100_bench.harness.trace import CALL_RANGE

# the runtime calls that put work on the card: kernel launches, copies, fills
LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel\w*|"
                    r"cudaMemcpyAsync|cudaMemsetAsync)$")


def calls_with_events(run, entry):
    """[(start, end, [(start, end, name)])] of the traced calls of
    ``entry``: each call's interval and the host events on its thread
    that lie inside it."""
    if run.trace is None:
        return []
    by_thread = {}
    for a, b, name, thread in run.trace.host:
        by_thread.setdefault(thread, []).append((a, b, name))
    for events in by_thread.values():
        events.sort()
    starts = {t: [e[0] for e in events] for t, events in by_thread.items()}
    out = []
    for a, b, name, thread in run.trace.host:
        if not name.startswith(CALL_RANGE):
            continue
        if run.meta[name[len(CALL_RANGE):]]["entry"] != entry:
            continue
        events = by_thread[thread]
        lo, hi = bisect.bisect_left(starts[thread], a), bisect.bisect_right(starts[thread], b)
        out.append((a, b, [e for e in events[lo:hi] if e[1] <= b and e[2] != name]))
    return sorted(out, key=lambda c: c[0])


def span_ms(run, entry, step):
    """Summed milliseconds of the ``step`` spans (inclusive of the spans
    inside them) a traced call of ``entry``."""
    calls = calls_with_events(run, entry)
    rx = re.compile(rf"^{step} \d+:\d+$")
    found = [b - a for _, _, events in calls for a, b, n in events if rx.match(n)]
    return sum(found) / 1e3 / len(calls) if found else None


def launches(run, entry):
    """Runtime launch, copy and fill calls a traced call of ``entry``."""
    calls = calls_with_events(run, entry)
    if not calls:
        return None
    return sum(1 for _, _, events in calls for _, _, n in events if LAUNCH.match(n)) / len(calls)

