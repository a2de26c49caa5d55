"""atlite_tpu_torch — the PyTorch/CUDA port of atlite_tpu for NVIDIA Hopper.

The headline wind + PV + bus step (``entry.step_fn``) runs on a CUDA card
through one hand-written kernel (``ops/csrc/megakernel.cu``); the Cutout's
``convert_and_aggregate`` (wind, PV) runs resident or streamed in time
chunks with banded aggregation; ``ops/bsr_spmm.bsr_spmm_kernel`` is the
block-sparse aggregation entry (``ops/csrc/bsr_spmm.cu``).  On the CPU the
same entry points run the plain PyTorch modules, which the tests hold
against the JAX package.  Module names follow ``atlite_tpu`` so each
function's counterpart is found under the same path.

Importing the package builds and loads nothing: the CUDA libraries are
compiled at the first launch (``ops/_build.py``).
"""

from atlite_tpu_torch.cutout import Cutout
from atlite_tpu_torch.entry import (
    build_inputs,
    entry,
    example_inputs,
    from_jax_inputs,
    step_fn,
)

__version__ = "0.1.0"

__all__ = [
    "Cutout",
    "build_inputs",
    "entry",
    "example_inputs",
    "from_jax_inputs",
    "step_fn",
]
