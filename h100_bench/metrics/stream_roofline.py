"""The streamed call against its byte bound: 100 x the calls' byte bound
/ the card's busy time inside those calls, over the traced calls of the
``stream`` entry, at the card's published memory bandwidth.  A call
reads its fields' int16 codes once (2 B a value), writes the float32
fields once and the converter reads them once, the banded product reads
its (T, C) input once and writes its (B, T) output once, and the matrix's
nonzeros are read once (a float32 weight and an int32 column each); the
same work whatever implements it."""

from h100_bench.harness.peaks import hbm_bytes_per_s


def call_bytes(meta):
    T, C, B = meta["T"], meta["C"], meta["B"]
    values = len(meta["fields"]) * T * C
    return 2 * values + 8 * values + 4 * T * C + 4 * T * B + 8 * meta["nnz"]


def read(run):
    peak = hbm_bytes_per_s(run.device_kind)
    if run.trace is None or peak is None:
        return None
    bound_s = busy_s = 0.0
    for a, b, label in run.trace.calls:
        meta = run.meta[label]
        if meta["entry"] != "stream":
            continue
        bound_s += call_bytes(meta) / peak
        busy_s += run.trace.busy_us(a, b) / 1e6
    return 100.0 * bound_s / busy_s if busy_s > 0 else None
