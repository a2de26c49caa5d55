"""The host's time to enqueue one fused step (``entry.step_fn``'s call
until it returns, before the synchronise), averaged over the window's
steps; host clock."""


def read(run):
    return 1e3 * sum(run.enqueue_s) / len(run.enqueue_s) if run.enqueue_s else None
