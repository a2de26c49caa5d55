"""GEBCO bathymetry/topography adapter (counterpart of
``atlite_tpu/datasets/gebco.py``).

atlite's gebco module (its datasets/gebco.py:20-87): a 'height' static
feature produced by average-resampling a fine elevation raster onto the
cutout grid (atlite delegates to rasterio windowed reads +
Resampling.average; here the port's ``gis/raster.reproject_average`` does
the same).

The raster is supplied via ``gebco_path`` pointing at an .npz or GeoTIFF
Raster (see atlite_tpu_torch.gis.raster.Raster) or a Raster instance via
``gebco_raster``.
"""

from __future__ import annotations

import numpy as np

from atlite_tpu_torch.gis.raster import Raster, reproject_average

crs = 4326

features = {"height": ["height"]}
static_features = {"height"}


def get_data_gebco_height(raster: Raster, grid):
    """Average-resample the elevation raster onto the cutout grid; returns a
    (Y, X) array in ascending-y order (the reference flips the GDAL
    top-down output, gebco.py:30-38)."""
    out = reproject_average(raster, grid.transform_r, crs, grid.shape)
    return np.asarray(out)[::-1]


def get_data(cutout, feature, tmpdir=None, **creation_parameters):
    raster = creation_parameters.get("gebco_raster")
    if raster is None:
        path = creation_parameters.get("gebco_path") or cutout.attrs.get("gebco_path")
        if path is None:
            raise ValueError(
                "The gebco module requires 'gebco_path' (an .npz Raster) or "
                "'gebco_raster' (a Raster instance) as creation parameter."
            )
        raster = Raster.open(path)
    height = get_data_gebco_height(raster, cutout.grid_desc)
    return {"height": (("y", "x"), height)}
