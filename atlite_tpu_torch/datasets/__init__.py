"""Dataset module registry of the PyTorch port (counterpart of
``atlite_tpu/datasets/__init__.py``).

Each module exposes ``crs``, ``features`` (feature -> list of variables),
``static_features`` and ``get_data(cutout, feature, tmpdir=None,
**params)``.  Only the deterministic offline generator is ported.
"""

from atlite_tpu_torch.datasets import synthetic

modules = {"synthetic": synthetic}
