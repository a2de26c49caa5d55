"""The whole window divided by the calls it completed; host clock."""


def read(run):
    return 1e3 * run.window_s / len(run.durations)
