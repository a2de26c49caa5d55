"""The call time of the cells that drive the heat entry, as a per-layer
metric: the whole window over the calls it completed (the traffic's
calls in turn); host clock."""

from h100_bench.harness import named

read = named.module("metrics", "call_ms").read
