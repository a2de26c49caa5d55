"""Share of the traced stretch in which the card ran nothing: 100 x (1 -
union of kernel, copy and fill intervals / wall), from torch.profiler."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    lo, hi = run.trace.stretch
    return 100.0 * (1.0 - run.trace.busy_us() / (hi - lo))
