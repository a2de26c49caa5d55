"""Dataset module registry of the PyTorch port (counterpart of
``atlite_tpu/datasets/__init__.py``).

Each module exposes ``crs``, ``features`` (feature -> list of variables),
``static_features`` and ``get_data(cutout, feature, tmpdir=None,
**params)``: ``era5`` (CDS retrieval or offline GRIB/NetCDF files),
``sarah`` (satellite irradiance archives), ``gebco`` (elevation raster)
and ``synthetic``, the deterministic offline generator.  ``ncep`` and
``cordex`` are importable placeholders outside the registry, as in the
JAX package.
"""

from atlite_tpu_torch.datasets import era5, gebco, sarah, synthetic

modules = {
    "era5": era5,
    "sarah": sarah,
    "gebco": gebco,
    "synthetic": synthetic,
}
