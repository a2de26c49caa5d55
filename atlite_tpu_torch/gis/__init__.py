"""GIS of the port (counterpart of ``atlite_tpu/gis/__init__.py``), under
the JAX package's names: the indicator and intersection matrices, on the
host geometry and CRS math of ``gis.geometry`` and ``gis.crs``.  Rasters,
exclusions, the availability matrix and regridding wait for later slices
(ROADMAP queue 1)."""

from atlite_tpu_torch.core.grid import coordinate_range as get_coords
from atlite_tpu_torch.gis.matrix import (
    compute_indicatormatrix,
    compute_intersectionmatrix,
    spdiag,
)

__all__ = ["compute_indicatormatrix", "compute_intersectionmatrix", "get_coords", "spdiag"]
