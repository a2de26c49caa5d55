"""GIS of the port (counterpart of ``atlite_tpu/gis/__init__.py``), the
namespace of atlite's flat ``atlite.gis`` module over the submodules, under
the JAX package's names: the indicator and intersection matrices, rasters
and their GeoTIFF I/O, exclusions and the availability matrix (host path,
and the device path of ``gis.kernels``), and regridding."""

from atlite_tpu_torch.core.grid import coordinate_range as get_coords  # atlite gis.py:36
from atlite_tpu_torch.gis.exclusion import (
    ExclusionContainer,
    compute_availabilitymatrix,
    shape_availability,
    shape_availability_reprojected,
)
from atlite_tpu_torch.gis.matrix import (
    compute_indicatormatrix,
    compute_intersectionmatrix,
    spdiag,
)
from atlite_tpu_torch.gis.raster import (
    Raster,
    geometry_mask,
    pad_extent,
    padded_transform_and_shape,
    projected_mask,
    reproject_average,
    reproject_nearest,
)
from atlite_tpu_torch.gis.regrid import Resampling, regrid


def maybe_swap_spatial_dims(da, namex="x", namey="y"):
    """Normalize a DataArray to ascending x / ascending y coordinate order
    (atlite gis.py:765-779)."""
    swaps = {}
    cx = da.coords[namex]
    cy = da.coords[namey]
    if len(cx) > 1 and cx[0] > cx[-1]:
        swaps[namex] = slice(None, None, -1)
    if len(cy) > 1 and cy[0] > cy[-1]:
        swaps[namey] = slice(None, None, -1)
    return da.isel(**swaps) if swaps else da


def reproject_shapes(shapes, crs1, crs2):
    """Project a collection of shapes between CRSs (atlite gis.py:87-101):
    a pandas-like Series (read duck-typed, mapped with its ``map``), a dict
    or a list."""
    from atlite_tpu_torch.gis.geometry import parse_geometry, transform_geometry

    def reproject(s):
        return transform_geometry(parse_geometry(s), crs1, crs2)

    if isinstance(shapes, dict):
        return {k: reproject(v) for k, v in shapes.items()}
    if hasattr(shapes, "map") and hasattr(shapes, "index"):
        return shapes.map(reproject)
    return [reproject(s) for s in shapes]


__all__ = [
    "ExclusionContainer", "Raster", "Resampling",
    "compute_availabilitymatrix", "compute_indicatormatrix",
    "compute_intersectionmatrix", "geometry_mask", "pad_extent",
    "padded_transform_and_shape", "regrid", "reproject_average",
    "reproject_nearest", "reproject_shapes", "shape_availability",
    "shape_availability_reprojected", "spdiag",
]
