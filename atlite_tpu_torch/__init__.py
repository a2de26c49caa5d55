"""atlite_tpu_torch — the PyTorch/CUDA port of atlite_tpu for NVIDIA Hopper.

The headline wind + PV + bus step (``entry.step_fn``) runs on a CUDA card
through one hand-written kernel (``ops/csrc/megakernel.cu``); the Cutout,
in memory or reopened from its ``.atc`` store (``core/store.py``), runs
every converter through ``convert_and_aggregate``, resident or streamed in
time chunks with banded aggregation; ``ops/bsr_spmm.bsr_spmm_kernel`` is the
block-sparse aggregation entry (``ops/csrc/bsr_spmm.cu``); the availability
(land-eligibility) matrix runs batched on the card (``gis/kernels.py``); weather comes from
the port's own GRIB/NetCDF/HDF5 codecs (``io/``) through the era5, sarah and gebco dataset
modules, and cutouts persist as NetCDF files too (``Cutout.to_netcdf``).  On the CPU the
same entry points run the plain PyTorch modules, which the tests hold
against the JAX package.  Module names follow ``atlite_tpu`` so each
function's counterpart is found under the same path.

Importing the package builds and loads nothing: the CUDA libraries are
compiled at the first launch (``ops/_build.py``).
"""

from atlite_tpu_torch.aggregate import aggregate_matrix
from atlite_tpu_torch.cutout import Cutout
from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.entry import (
    build_inputs,
    dryrun_multichip,
    entry,
    example_inputs,
    from_jax_inputs,
    sharded_step_fn,
    step_fn,
)
from atlite_tpu_torch.gis.exclusion import ExclusionContainer
from atlite_tpu_torch.gis.matrix import compute_indicatormatrix, compute_intersectionmatrix
from atlite_tpu_torch.gis.regrid import regrid
from atlite_tpu_torch.resource import (
    cspinstallations,
    get_cspinstallationconfig,
    get_solarpanelconfig,
    get_windturbineconfig,
    solarpanels,
    windturbine_smooth,
    windturbines,
)

__version__ = "0.1.0"

__all__ = [
    "Cutout",
    "DataArray",
    "ExclusionContainer",
    "aggregate_matrix",
    "compute_indicatormatrix",
    "compute_intersectionmatrix",
    "regrid",
    "windturbines",
    "solarpanels",
    "cspinstallations",
    "get_windturbineconfig",
    "get_solarpanelconfig",
    "get_cspinstallationconfig",
    "windturbine_smooth",
    "build_inputs",
    "dryrun_multichip",
    "entry",
    "example_inputs",
    "from_jax_inputs",
    "sharded_step_fn",
    "step_fn",
]
