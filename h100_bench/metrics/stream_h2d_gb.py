"""Bytes a call the streamer moves to the card, in GB: what the program's
counter ``Cutout.streamed_bytes`` (the packed or raw host stacks copied)
grew by over the stream entry's calls, divided by those calls; None where
the program has no such counter."""

from h100_bench.harness import named


def read(run):
    b = named.module("entries", "stream").per_call(run, "streamed_bytes")
    return None if b is None else b / 1e9
