"""The caller's wait for staged chunks a call, in ms: what the program's
counter ``Cutout.stream_wait_s`` (the seconds the calling thread waits for
the worker's next chunk: the card starving for host work) grew by over
the stream entry's calls, divided by those calls; None where the program
has no such counter."""

from h100_bench.harness import named


def read(run):
    s = named.module("entries", "stream").per_call(run, "stream_wait_s")
    return None if s is None else 1e3 * s
