"""CORDEX adapter — deprecated placeholder (counterpart
of ``atlite_tpu/datasets/cordex.py``).

Mirrors the reference's non-functional cordex module
(atlite's datasets/cordex.py, un-importable there and
excluded from the registry): present for discoverability, raises on use.
"""

crs = 4326
features: dict = {}
static_features: set = set()


def get_data(cutout, feature, **params):
    raise DeprecationWarning(
        "The cordex module is deprecated and un-ported (matching the "
        "reference); use module='era5' or 'synthetic'."
    )
