"""The PROJ pins and the LCC, polar stereographic, rotated-pole, datum
(OSGB, DHDN) and CEA cases of ``tests/test_crs_proj_goldens.py`` and
``tests/test_crs_lcc.py``, run through the port's device formulation:
``transform_points_xp(..., torch)`` over tensors (``TorchNamespace``),
which computes in float32 as the availability matrix does on the card.
The host path (numpy float64) is held too.

Tolerance: the host path the JAX tests' own.  The torch path: the JAX
test's tolerance or 2e-6 of the scale of the quantities the projection
carries, whichever is larger: the Earth's radius for metres (12.8 m,
16 float32 ulps of a 6.4e6 m meridian arc) and 180 deg for degrees
(3.6e-4 deg).  That still tells apart every fault these pins were made
for (the smallest, a dropped DHDN datum shift, moves a point 115 m).
The scale-factor cases take derivatives by steps of 1e-6 deg and run on
the host path only.
"""

import numpy as np
import pytest
import torch

from atlite_tpu_torch.gis import crs

F32_REL = 2e-6
METRES, DEGREES = 6.378e6, 180.0  # the scales the float32 tolerance is relative to
PATHS = ["host", torch.float32]
IDS = ["host", "float32"]


def tfm(lon, lat, src, dst, path):
    """(x, y) as float64 numpy arrays through ``path``."""
    if path == "host":
        return crs.transform_points(np.asarray(lon, float), np.asarray(lat, float), src, dst)
    # float32 in, as the availability matrix's pixel centres are
    x, y = crs.transform_points_xp(torch.tensor(lon, dtype=torch.float32),
                                   torch.tensor(lat, dtype=torch.float32), src, dst, torch)
    assert x.dtype == y.dtype == torch.float32
    return x.double().numpy(), y.double().numpy()


def near(got, want, atol, path, scale=METRES):
    got, want = np.asarray(got, float), np.asarray(want, float)
    if path is torch.float32:
        atol = max(atol, F32_REL * scale)
    assert (np.abs(got - want) <= atol).all(), (got, want, atol)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_epsg_31370_matches_proj(path):
    x, y = tfm([4.3517], [50.8503], 4326, 31370, path)
    near(x[0], 148799.170, 0.05, path)
    near(y[0], 171100.155, 0.05, path)
    lon, lat = tfm(x, y, 31370, 4326, path)
    near([lon[0], lat[0]], [4.3517, 50.8503], 1e-7, path, DEGREES)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_proj4_tmerc_keeps_lat0_and_ellps(path):
    s = ("+proj=tmerc +lat_0=49 +lon_0=-2 +k=0.9996012717 "
         "+x_0=400000 +y_0=-100000 +ellps=airy")
    x, y = tfm([-0.1276], [51.5072], 4326, s, path)
    near(x[0], 529930.2723, 0.01, path)
    near(y[0], 180412.1108, 0.01, path)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_proj4_utm_keeps_ellps(path):
    _, y = tfm([9.0], [52.0], 4326, "+proj=utm +zone=32 +ellps=intl", path)
    _, y_grs = tfm([9.0], [52.0], 4326, "+proj=utm +zone=32 +ellps=grs80", path)
    assert abs(y[0] - y_grs[0]) > 50.0


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_polar_stereo_variant_a_no_lat_ts(path):
    x, y = tfm([10.0], [70.0], 4326, "+proj=stere +lat_0=90 +lon_0=0 +ellps=WGS84", path)
    assert np.isfinite([x[0], y[0]]).all()
    near(x[0], 391737.3209, 0.01, path)
    near(y[0], -2221652.7463, 0.01, path)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_polar_stereo_south_hemisphere_from_lat0(path):
    a = "+proj=stere +lat_0=-90 +lat_ts=-71 +lon_0=0 +ellps=WGS84"
    b = "+proj=stere +lat_0=-90 +lat_ts=71 +lon_0=0 +ellps=WGS84"
    xa, ya = tfm([20.0], [-75.0], 4326, a, path)
    xb, yb = tfm([20.0], [-75.0], 4326, b, path)
    np.testing.assert_array_equal([xa[0], ya[0]], [xb[0], yb[0]])
    near(xa[0], 560496.8781, 0.01, path)
    near(ya[0], 1539952.5162, 0.01, path)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_rotated_pole_third_angle_sign(path):
    s = "+proj=ob_tran +o_proj=longlat +o_lat_p=39.25 +lon_0=18 +o_lon_p=30"
    rlon, rlat = tfm([10.0], [50.0], 4326, s, path)
    near(rlon[0], 24.8673, 2e-4, path, DEGREES)
    near(rlat[0], -0.4724, 2e-4, path, DEGREES)
    lon, lat = tfm(rlon, rlat, s, 4326, path)
    near([lon[0], lat[0]], [10.0, 50.0], 1e-9, path, DEGREES)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_proj4_bessel_gauss_krueger(path):
    x, y = tfm([9.5], [50.0], 4326, "+proj=tmerc +lat_0=0 +lon_0=9 +k=1 +x_0=3500000 +ellps=bessel",
               path)
    near(x[0], 3535843.4288, 0.01, path)
    near(y[0], 5540399.3500, 0.01, path)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_proj4_datum_potsdam_applies_dhdn_shift(path):
    s = "+proj=tmerc +lat_0=0 +lon_0=9 +k=1 +x_0=3500000 +datum=potsdam"
    x, y = tfm([9.5], [50.0], 4326, s, path)
    near(x[0], 3535922.6569, 1.0, path)
    near(y[0], 5540527.2761, 1.0, path)
    lon, lat = tfm(x, y, s, 4326, path)
    near([lon[0], lat[0]], [9.5, 50.0], 1e-6, path, DEGREES)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_cea_with_datum_matches_proj(path):
    x, y = tfm([10.0], [50.0], 4326, "+proj=cea +lat_ts=30 +datum=potsdam", path)
    near(x[0], 964863.148, 0.5, path)
    near(y[0], 5613576.328, 0.5, path)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_lcc_natural_origins(path):
    x, y = tfm([10.0], [52.0], 4326, 3034, path)
    near([x[0], y[0]], [4000000.0, 2800000.0], 1e-6, path)
    x, y = tfm([3.0], [46.5], 4326, 2154, path)
    near([x[0], y[0]], [700000.0, 6600000.0], 1e-6, path)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
@pytest.mark.parametrize("code,lon,lat", [
    (3034, [-10.0, 25.0], [35.0, 65.0]),
    (2154, [-4.5, 8.0], [42.0, 51.0]),
    (31370, [2.6, 6.4], [49.5, 51.5]),
    (27700, [-7.0, 1.8], [50.0, 58.6]),
    (3413, [-45.0, 120.0], [65.0, 88.0]),
    (3031, [0.0, -150.0], [-65.0, -89.0]),
])
def test_roundtrip(code, lon, lat, path):
    x, y = tfm(lon, lat, 4326, code, path)
    hx, hy = tfm(lon, lat, 4326, code, "host")
    near(x, hx, 1e-6, path)
    near(y, hy, 1e-6, path)
    lon2, lat2 = tfm(x, y, code, 4326, path)
    tol = 1e-7 if code in (31370, 27700) else 1e-10
    near(lon2, lon, tol, path, DEGREES)
    near(lat2, lat, tol, path, DEGREES)


def scale_factors(code, lon, lat, d=1e-6):
    """Numerical local scale along the meridian (h) and the parallel (k)."""
    a, f = crs.ELLIPSOIDS["grs80"]
    e2 = f * (2 - f)
    phi = np.radians(lat)
    sin2 = np.sin(phi) ** 2
    M = a * (1 - e2) / (1 - e2 * sin2) ** 1.5
    N = a / np.sqrt(1 - e2 * sin2)
    x, y = tfm([lon, lon, lon + d], [lat, lat + d, lat], 4326, code, "host")
    dd = np.radians(d)
    h = np.hypot(x[1] - x[0], y[1] - y[0]) / (M * dd)
    k = np.hypot(x[2] - x[0], y[2] - y[0]) / (N * np.cos(phi) * dd)
    return h, k


def test_lcc_scale_unity_on_standard_parallels():
    for lat in (35.0, 65.0):
        h, k = scale_factors(3034, 12.0, lat)
        np.testing.assert_allclose([h, k], 1.0, rtol=1e-6)


def test_lcc_conformal_between_parallels():
    for lat in (40.0, 52.0, 60.0):
        h, k = scale_factors(3034, 5.0, lat)
        np.testing.assert_allclose(h, k, rtol=1e-6)
        assert k < 1.0


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_osgb_projection_worked_example(path):
    """OS 'A guide to coordinate systems in Great Britain': lat
    52d39'27.2531", lon 1d43'4.5177" -> E 651409.903, N 313177.270."""
    fwd, inv = crs._make_tmerc(-2.0, 0.9996012717, 400000.0, -100000.0, lat0=49.0, ellps="airy")
    lat = 52 + 39 / 60 + 27.2531 / 3600
    lon = 1 + 43 / 60 + 4.5177 / 3600
    if path == "host":
        x, y = fwd(np.array([lon]), np.array([lat]))
        lon2, lat2 = inv(x, y)
    else:
        xp = crs.TorchNamespace(torch.device("cpu"))
        tx, ty = fwd(torch.tensor([lon], dtype=path), torch.tensor([lat], dtype=path), xp)
        lon2, lat2 = (v.double().numpy() for v in inv(tx, ty, xp))
        x, y = tx.double().numpy(), ty.double().numpy()
    near(x[0], 651409.903, 1e-3, path)
    near(y[0], 313177.270, 1e-3, path)
    near([lon2[0], lat2[0]], [lon, lat], 1e-9, path, DEGREES)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_osgb_datum_shift_anchor(path):
    x, y = tfm([-0.0014], [51.4779], 4326, 27700, path)
    assert abs(x[0] - 538890) < 15 and abs(y[0] - 177330) < 15


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_polar_stereo_poles_and_axes(path):
    x, y = tfm([0.0], [90.0], 4326, 3413, path)
    near([x[0], y[0]], [0.0, 0.0], 1e-6, path)
    x, y = tfm([0.0], [-90.0], 4326, 3031, path)
    near([x[0], y[0]], [0.0, 0.0], 1e-6, path)
    x, y = tfm([-45.0], [80.0], 4326, 3413, path)
    near(x[0], 0.0, 1e-6, path)
    assert y[0] < 0
    x, y = tfm([0.0], [-80.0], 4326, 3031, path)
    near(x[0], 0.0, 1e-6, path)
    assert y[0] > 0


def test_polar_stereo_scale_at_lat_ts():
    a, f = crs.ELLIPSOIDS["wgs84"]
    e2 = f * (2 - f)
    for code, lat in ((3413, 70.0), (3031, -71.0)):
        d = 1e-6
        x, y = tfm([10.0, 10.0 + d], [lat, lat], 4326, code, "host")
        N = a / np.sqrt(1 - e2 * np.sin(np.radians(lat)) ** 2)
        k = np.hypot(x[1] - x[0], y[1] - y[0]) / (N * np.cos(np.radians(lat)) * np.radians(d))
        np.testing.assert_allclose(k, 1.0, rtol=1e-6)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_proj4_lcc_and_polar_stereo_match_epsg(path):
    s = ("+proj=lcc +lat_1=44 +lat_2=49 +lat_0=46.5 +lon_0=3 "
         "+x_0=700000 +y_0=6600000 +ellps=GRS80")
    near(tfm([2.35], [48.85], 4326, s, path), tfm([2.35], [48.85], 4326, 2154, path), 1e-9, path)
    s = "+proj=stere +lat_0=90 +lat_ts=70 +lon_0=-45 +x_0=0 +y_0=0 +ellps=WGS84"
    near(tfm([10.0], [75.0], 4326, s, path), tfm([10.0], [75.0], 4326, 3413, path), 1e-9, path)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_epsg_coverage_breadth(path):
    for code in (4326, 4258, 3035, 3857, 3034, 2154, 31370, 27700, 3413, 3031, 32630, 25832):
        lat = {3413: 80.0, 3031: -80.0}.get(code, 50.0)
        x, y = tfm([0.0 if code == 3031 else 5.0], [lat], 4326, code, path)
        hx, hy = tfm([0.0 if code == 3031 else 5.0], [lat], 4326, code, "host")
        assert np.isfinite(x).all() and np.isfinite(y).all()
        near([x[0], y[0]], [hx[0], hy[0]], 1e-6, path)


EURO_CORDEX = {"grid_north_pole_longitude": -162.0, "grid_north_pole_latitude": 39.25}


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_rotated_pole_euro_cordex_anchors(path):
    lon, lat = tfm([0.0], [0.0], EURO_CORDEX, 4326, path)
    near([lon[0], lat[0]], [18.0, 50.75], 1e-9, path, DEGREES)
    rlon, rlat = tfm([18.0], [50.75], 4326, EURO_CORDEX, path)
    near([rlon[0], rlat[0]], [0.0, 0.0], 1e-9, path, DEGREES)
    rlon, rlat = tfm([0.0], [90.0], 4326, EURO_CORDEX, path)
    near(rlon[0], 0.0, 1e-9, path, DEGREES)
    near(rlat[0], 39.25, 1e-9, path, DEGREES)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_rotated_pole_roundtrip_and_isometry(path):
    rng = np.random.default_rng(3)
    lon, lat = rng.uniform(-25, 45, 50), rng.uniform(30, 72, 50)
    rlon, rlat = tfm(lon, lat, 4326, EURO_CORDEX, path)
    lon2, lat2 = tfm(rlon, rlat, EURO_CORDEX, 4326, path)
    near(lon2, lon, 1e-9, path, DEGREES)
    near(lat2, lat, 1e-9, path, DEGREES)

    def ang(lo1, la1, lo2, la2):
        lo1, la1, lo2, la2 = map(np.radians, (lo1, la1, lo2, la2))
        return np.arccos(np.clip(np.sin(la1) * np.sin(la2)
                                 + np.cos(la1) * np.cos(la2) * np.cos(lo1 - lo2), -1, 1))

    d_true = ang(lon[:-1], lat[:-1], lon[1:], lat[1:])
    d_rot = ang(rlon[:-1], rlat[:-1], rlon[1:], rlat[1:])
    # in radians: each end of a distance carries its error
    near(d_rot, d_true, 1e-12, path, 2 * np.pi)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_rotated_pole_proj4_ob_tran(path):
    s = "+proj=ob_tran +o_proj=longlat +o_lat_p=39.25 +lon_0=18.0 +o_lon_p=0"
    lon, lat = tfm([0.0], [0.0], s, 4326, path)
    near([lon[0], lat[0]], [18.0, 50.75], 1e-9, path, DEGREES)
