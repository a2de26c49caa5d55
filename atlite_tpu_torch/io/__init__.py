"""Self-contained scientific-format IO of the port (counterpart of
``atlite_tpu/io``), with no netCDF4/HDF5/eccodes C dependencies and no
pandas:

- netcdf3:  NetCDF classic / 64-bit-offset reader AND writer
- hdf5:     pure-python HDF5 reader subset (NETCDF4-model files)
- hdf5_write: the NETCDF4 writer (byte for byte the JAX package's)
- netcdf:   unified front door (magic-byte sniffing) + CF time on numpy
- grib:     GRIB edition 1 and 2 decoder and encoder
- png, jp2, aec, zstd, szip: the codecs of GRIB2 templates and HDF5
  filters (the last four through system libraries by ctypes)
- cds:      the Climate Data Store client (``requests``, imported lazily)
"""

from atlite_tpu_torch.io.netcdf import read_netcdf, write_netcdf  # noqa: F401
