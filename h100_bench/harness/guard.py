"""The check that no run loads JAX or the JAX package."""

from __future__ import annotations

import sys

# compared whole against each loaded module's top-level name, so that the
# port (atlite_tpu_torch) does not match the JAX package (atlite_tpu)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "atlite_tpu"})


def forbidden_modules(names=None):
    """Sorted top-level names among ``names`` (default: ``sys.modules``)
    that are JAX or the JAX package."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
