"""The call time of the cells that drive the stream entry, as a per-layer
metric: the whole window over the calls it completed; host clock."""

from h100_bench.harness import named

read = named.module("metrics", "call_ms").read
