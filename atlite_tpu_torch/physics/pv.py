"""PV panel electrical models (counterpart of ``atlite_tpu/physics/pv.py``):
the Huld et al. (2010) log-polynomial efficiency model and the
Beyer/Bofinger MPP model."""

from __future__ import annotations

import math

import torch


def power_huld(irradiance, t_amb, pc):
    """AC power per unit capacity, Huld model."""
    T_ = (pc["c_temp_amb"] * t_amb + pc["c_temp_irrad"] * irradiance) - pc["r_tmod"]
    G_ = irradiance / pc["r_irradiance"]
    log_G_ = torch.log(torch.where(G_ > 0, G_, torch.nan))
    eff = (
        1
        + pc["k_1"] * log_G_
        + pc["k_2"] * log_G_**2
        + T_ * (pc["k_3"] + pc["k_4"] * log_G_ + pc["k_5"] * log_G_**2)
        + pc["k_6"] * T_**2
    )
    eff = torch.clamp(torch.nan_to_num(eff, nan=0.0), min=0.0)
    return G_ * eff * pc.get("inverter_efficiency", 1.0)


def power_bofinger(irradiance, t_amb, pc):
    """AC power per unit capacity, Bofinger model."""
    fraction = (pc["NOCT"] - pc["Tamb"]) / pc["Intc"]
    eta_ref = (
        pc["A"] + pc["B"] * irradiance
        + pc["C"] * torch.log(torch.where(irradiance != 0, irradiance, torch.nan))
    )
    eta = torch.nan_to_num(
        eta_ref
        * (1.0 + pc["D"] * (fraction * irradiance + (t_amb - pc["Tstd"])))
        / (1.0 + pc["D"] * fraction / pc["ta"] * eta_ref * irradiance),
        nan=0.0,
    )
    capacity = (pc["A"] + pc["B"] * 1000.0 + pc["C"] * math.log(1000.0)) * 1e3
    power = irradiance * eta * (pc.get("inverter_efficiency", 1.0) / capacity)
    return torch.where(irradiance >= pc["threshold"], power, 0.0)


def solar_panel_power(irradiance, temperature, pc):
    """Dispatch on the panel config's 'model'."""
    model = pc.get("model", "huld")
    if model == "huld":
        return power_huld(irradiance, temperature, pc)
    if model == "bofinger":
        return power_bofinger(irradiance, temperature, pc)
    raise AssertionError(f"Unknown panel model: {model}")
