"""``idle_share`` of the cells that drive the stream entry, which name
their own end-to-end metric as the one it moves: 100 x (1 - union of
device intervals / wall of the traced calls)."""

from h100_bench.harness import named

read = named.module("metrics", "idle_share").read
