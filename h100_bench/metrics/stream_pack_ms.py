"""The streamer's host packing a call, in ms: what the program's counter
``Cutout.stream_pack_s`` (the worker's seconds inside ``_pack``) grew by
over the stream entry's calls, divided by those calls; None where the
program has no such counter."""

from h100_bench.harness import named


def read(run):
    s = named.module("entries", "stream").per_call(run, "stream_pack_s")
    return None if s is None else 1e3 * s
