"""Aggregation matrices of rectangles over a grid, weighted from the seed."""

from __future__ import annotations

import hashlib

import numpy as np
import scipy.sparse as sp


def region_of_cells(x, y, ny, nx):
    """(C,) rectangle of each cell (row-major over (y, x)), by its centre,
    among ny x nx equal rectangles over the grid's extent (the layout of
    ``chip_smoke.region_matrix``)."""
    x, y = np.asarray(x), np.asarray(y)
    gx = np.linspace(x[0], x[-1], nx + 1)
    gy = np.linspace(y[0], y[-1], ny + 1)
    ix = np.clip(np.searchsorted(gx, x, side="right") - 1, 0, nx - 1)
    iy = np.clip(np.searchsorted(gy, y, side="right") - 1, 0, ny - 1)
    return (iy[:, None] * nx + ix[None, :]).ravel()


def weighted_matrix(x, y, ny, nx, seed, name, lo):
    """(ny * nx, C) float32 CSR matrix: each cell to its rectangle, with a
    weight in [lo, 1) drawn from (seed, name); it stands for availability
    x area x capacity density.  Every seed gives the same structure."""
    bus = region_of_cells(x, y, ny, nx)
    digest = hashlib.sha256(f"{int(seed)}:matrix:{name}".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
    w = (lo + (1.0 - lo) * rng.random(bus.size)).astype(np.float32)
    return sp.csr_matrix((w, (bus, np.arange(bus.size))), shape=(ny * nx, bus.size))
