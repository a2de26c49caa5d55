"""The call time of the cells that drive the convert entry, as a
per-layer metric: the whole window over the calls it completed; host
clock.  Their calls are held by the host's Python, whose speed varies
from machine to machine by more than an end-to-end bound can hold."""

from h100_bench.harness import named

read = named.module("metrics", "call_ms").read
