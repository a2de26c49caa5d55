"""The card's peak allocated memory in GB (``torch.cuda.max_memory_allocated``),
from the program's staging on: the Cutout staged, the warm calls and the
window.  The weather that the benchmark makes on the card before it is
left out: ``harness/cutout.py`` resets the peak once it is on the host."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 1e9
