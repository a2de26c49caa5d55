"""ERA5-like weather made from the seed on the device.

The recipe is that of the port's synthetic dataset module (smooth
harmonics in space and time, the solar position of the hour's centre, a
land mask for the soil temperature), computed with ``torch`` on the card
in a few large calls instead of float64 numpy on the host, and seeded
per variable from ``--seed``.  The benchmark hands the same arrays to
the program (through a Cutout) and to the plain reference.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

SOLAR_CONSTANT = 1361.0  # W/m^2
EPOCH = np.datetime64("2000-01-01", "ns")

FEATURES = {
    "wind": ("wnd100m", "wnd_shear_exp", "wnd_azimuth", "roughness"),
    "influx": ("influx_toa", "influx_direct", "influx_diffuse", "albedo",
               "solar_altitude", "solar_azimuth"),
    "temperature": ("temperature", "soil temperature", "dewpoint temperature"),
    "runoff": ("runoff",),
    "height": ("height",),
}
STATIC = {"height"}


def feature_of(name):
    for feature, names in FEATURES.items():
        if name in names:
            return feature
    raise KeyError(f"no feature makes {name!r}")


def _generator(seed, name, device):
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") & ((1 << 63) - 1))
    return g


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)


class Weather:
    """The grid's coordinates on ``device`` and the fields made from
    ``seed``: ``feature(name)`` returns {variable: float32 tensor}, (T, Y,
    X) for time variables and (Y, X) for ``height``."""

    def __init__(self, x, y, times, seed, device):
        self.seed, self.device = int(seed), torch.device(device)
        self.x = np.asarray(x, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        self.times = np.asarray(times, dtype="datetime64[ns]")
        self.hours = (self.times - EPOCH).astype(np.int64) / 3.6e12
        dev = self.device
        self.lon = torch.as_tensor(np.radians(self.x), device=dev)  # (X,) float64
        self.lat = torch.as_tensor(np.radians(self.y), device=dev)  # (Y,)
        self.shape = (len(self.times), len(self.y), len(self.x))

    # -- building blocks -------------------------------------------------
    def smooth(self, name, nharm=4):
        """A smooth space-time field in [0, 1], float32 (T, Y, X)."""
        g = _generator(self.seed, name, self.device)
        dev = self.device
        T, Y, X = self.shape
        acc = torch.zeros((T, Y, X), dtype=torch.float32, device=dev)
        periods = torch.tensor([24.0, 24.0 * 365, 37.0, 11.0], dtype=torch.float64, device=dev)
        for _ in range(nharm):
            fx, fy = _uniform(g, 2, 0.5, 4.0, dev)
            ft = 1.0 / periods[torch.randint(0, 4, (1,), generator=g, device=dev)][0]
            px, py, pt = _uniform(g, 3, 0.0, 2 * math.pi, dev)
            amp = _uniform(g, 1, 0.3, 1.0, dev)[0]
            # phases wrapped in float64 before the float32 products
            wt = torch.as_tensor(self.hours, device=dev) * ft * (2 * math.pi)
            a_t = torch.remainder(wt + px, 2 * math.pi).float()[:, None, None]
            b_t = (0.3 * torch.sin(torch.remainder(wt + pt, 2 * math.pi))).float()[:, None, None]
            a_x = (fx * self.lon).float()[None, None, :]
            b_y = (fy * self.lat + py).float()[None, :, None]
            acc += float(amp) * torch.sin(a_t + a_x) * torch.cos(b_y + b_t)
        acc /= acc.abs().max() + 1e-12
        return acc.mul_(0.5).add_(0.5)

    def static(self, name, nharm=5):
        """A smooth (Y, X) field in [0, 1], float32."""
        g = _generator(self.seed, name, self.device)
        dev = self.device
        acc = torch.zeros(self.shape[1:], dtype=torch.float64, device=dev)
        for _ in range(nharm):
            fx, fy = _uniform(g, 2, 0.5, 6.0, dev)
            px, py = _uniform(g, 2, 0.0, 2 * math.pi, dev)
            amp = _uniform(g, 1, 0.3, 1.0, dev)[0]
            acc += amp * torch.sin(fx * self.lon + px)[None, :] * torch.cos(fy * self.lat + py)[:, None]
        acc /= acc.abs().max() + 1e-12
        return (0.5 + 0.5 * acc).float()

    def solar_position(self):
        """(altitude, azimuth) float64 (T, Y, X) at the hour's centre (ERA5
        fluxes are means over the hour before the stamp), by the Michalsky
        almanac approximation."""
        t = self.times - np.timedelta64(30, "m")
        n = (t - np.datetime64("2000-01-01T12:00", "ns")).astype(np.int64) / 8.64e13
        ut = ((t - t.astype("datetime64[D]")).astype(np.int64) / 3.6e12)
        L = 280.460 + 0.9856474 * n
        gm = np.radians(357.528 + 0.9856003 * n)
        ecl = np.radians(L + 1.915 * np.sin(gm) + 0.020 * np.sin(2 * gm))
        ep = np.radians(23.439 - 4e-7 * n)
        ra = np.arctan2(np.cos(ep) * np.sin(ecl), np.cos(ecl))
        h0 = (np.radians((6.697375 + ut + 0.0657098242 * n) * 15.0) - ra + np.pi) % (2 * np.pi) - np.pi
        dec = np.arcsin(np.sin(ep) * np.sin(ecl))
        dev = self.device
        dec = torch.as_tensor(dec, device=dev)[:, None, None]
        h = torch.remainder(torch.as_tensor(h0, device=dev)[:, None, None]
                            + self.lon[None, None, :] + math.pi, 2 * math.pi) - math.pi
        lat = self.lat[None, :, None]
        sin_alt = torch.clamp(torch.sin(dec) * torch.sin(lat)
                              + torch.cos(dec) * torch.cos(lat) * torch.cos(h), -1.0, 1.0)
        alt = torch.arcsin(sin_alt)
        cos_az = torch.clamp((torch.sin(dec) * torch.cos(lat) - torch.cos(dec) * torch.sin(lat)
                              * torch.cos(h)) / torch.cos(alt), -1.0, 1.0)
        az = torch.arccos(cos_az)
        az = torch.where(h <= 0, az, 2 * math.pi - az)
        return alt, az

    # -- features --------------------------------------------------------
    def feature(self, feature):
        T = self.shape[0]
        if feature == "height":
            return {"height": self.static("height") * 2200.0 - 200.0}
        if feature == "wind":
            w100 = 2.0 + 18.0 * self.smooth("wnd100m") ** 1.5
            sigma = 0.1 + 0.25 * self.smooth("shear")
            rough = 2e-4 + 1.2 * self.static("roughness") ** 3
            return {"wnd100m": w100, "wnd_shear_exp": sigma,
                    "wnd_azimuth": 2 * math.pi * self.smooth("wnd_azimuth"),
                    "roughness": rough.expand(T, -1, -1).contiguous()}
        if feature == "influx":
            alt, az = self.solar_position()
            toa = (SOLAR_CONSTANT * torch.clamp(torch.sin(alt), min=0.0)).float()
            clearness = 0.3 + 0.55 * self.smooth("clearness")
            total = clearness * toa
            direct = torch.clamp(1.4 * (clearness - 0.25), 0.0, 0.9) * total
            albedo = 0.05 + 0.3 * self.static("albedo")
            return {"influx_toa": toa, "influx_direct": direct, "influx_diffuse": total - direct,
                    "albedo": albedo.expand(T, -1, -1).contiguous(),
                    "solar_altitude": alt.float(), "solar_azimuth": az.float()}
        if feature == "temperature":
            doy = ((self.times - self.times.astype("datetime64[Y]")).astype("timedelta64[D]")
                   .astype(np.int64) + 1)
            hour = ((self.times - self.times.astype("datetime64[D]")).astype(np.int64) // 3.6e12)
            dev = self.device
            seasonal = torch.as_tensor(np.cos(2 * np.pi * (doy - 200) / 365.0), device=dev)
            diurnal = torch.as_tensor(np.cos(2 * np.pi * (hour - 14) / 24.0), device=dev)
            base = 255.0 + 35.0 * torch.cos(self.lat)
            level = (base[None, :, None] + 8.0 * seasonal[:, None, None]
                     + 4.0 * diurnal[:, None, None]).float()
            temp = level + 6.0 * (self.smooth("temperature") - 0.5)
            sea = self.static("landmask") < 0.25
            soil = temp + 2.0 * (self.smooth("soil") - 0.5)
            soil = torch.where(sea[None], torch.nan, soil)
            dew = temp - (2.0 + 8.0 * self.smooth("dewpoint"))
            return {"temperature": temp, "soil temperature": soil, "dewpoint temperature": dew}
        if feature == "runoff":
            r = self.smooth("runoff")
            return {"runoff": torch.clamp(r - 0.35, min=0.0) ** 2 * 2e-3}
        raise KeyError(f"unknown feature {feature!r}")

    def fields(self, names):
        """(name, float32 tensor) of the named variables, a feature at a
        time, so that only one feature's fields are on the device at once."""
        for feature in dict.fromkeys(feature_of(n) for n in names):
            for n, t in self.feature(feature).items():
                if n in names:
                    yield n, t
