"""The availability call against its byte bound: 100 x the calls' byte
bound / the card's busy time inside those calls, over the traced calls of
the ``avail`` entry.  A call reads each distinct raster once over the
lattice box of the regions (1 B a pixel) and writes the (S, NY, NX)
float32 matrix once, at the card's published memory bandwidth (the
entry's ``bound_bytes``); the same work whatever implements it."""

from h100_bench.harness.peaks import hbm_bytes_per_s


def read(run):
    peak = hbm_bytes_per_s(run.device_kind)
    if run.trace is None or peak is None:
        return None
    bound_s = busy_s = 0.0
    for a, b, label in run.trace.calls:
        meta = run.meta[label]
        if meta["entry"] != "avail":
            continue
        bound_s += meta["bound_bytes"] / peak
        busy_s += run.trace.busy_us(a, b) / 1e6
    return 100.0 * bound_s / busy_s if busy_s > 0 else None
