"""Set-up and calls of one cell.  The traffic's ``entry`` names the
module ``entries/<entry>.py`` that builds the cell's calls and judges
their answers; this file knows no entry.

A session holds the inputs its entry made (host arrays, matrices), so
that the reference reads the very same after the program's state is
freed.
"""

from __future__ import annotations

import gc
import time

import torch

from h100_bench.harness import named
from h100_bench.harness.regions import weighted_matrix


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """One cell's program state and inputs.  ``calls`` is the round-robin
    list of (label, call); ``meta[label]`` the shapes the metrics read;
    ``entry`` the module that built them."""

    def __init__(self, config, traffic, seed, device, bench=named.BENCH):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.entry = named.module("entries", traffic["entry"], bench)
        self.bench = bench
        self.calls, self.meta, self.matrices = [], {}, {}
        self.state = None     # what the entry keeps of the program besides its calls
        self.enqueue_s = []   # host seconds to enqueue a call, where the entry times it
        self.cleanups = []    # what close() undoes besides freeing the state
        self.phases = {}      # seconds of each part of the set-up, for the log
        t0 = time.perf_counter()
        self.entry.build(self)
        self.phases["build"] = time.perf_counter() - t0

    def add(self, label, call, meta):
        """A call of the round robin, with the shapes its metrics read."""
        self.calls.append((label, call))
        self.meta[label] = dict(meta, entry=self.traffic["entry"])

    def matrix(self, name, ny, nx):
        """The (ny * nx, C) seeded rectangle matrix ``name`` over the grid."""
        m = weighted_matrix(self.x, self.y, ny, nx, self.seed, name,
                            self.config["regions"]["weight_min"])
        self.matrices[name] = m
        return m

    def warm(self):
        """One call of each kind: builds or loads the kernels, stages the
        fields, fills the allocator; the enqueue times restart."""
        t0 = time.perf_counter()
        for _, call in self.calls:
            call()
        sync(self.device)
        self.enqueue_s.clear()
        self.phases["warm"] = time.perf_counter() - t0

    def close(self):
        """Free the program's state (the inputs stay for the reference)."""
        self.calls = []
        self.state = None
        for undo in self.cleanups:
            undo()
        self.cleanups = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
