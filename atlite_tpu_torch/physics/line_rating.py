"""IEEE-738 dynamic line rating (counterpart of
``atlite_tpu/physics/line_rating.py``): the conductor's steady-state heat
balance (forced and natural convection, radiation, solar gain) solved for
the current, per cell, and the rating of each line as the minimum over
its cells.  Lines come as a padded (L, K) cell plan with a validity mask.
"""

from __future__ import annotations

import math

import torch


def ampacity(fields, psi, R, D=0.028, Ts=373, epsilon=0.6, alpha=0.6):
    """Maximal current per cell [A].

    fields: dict of tensors 'temperature', 'wnd100m', 'height',
    'wnd_azimuth', 'influx_direct', 'solar_altitude', 'solar_azimuth'
    of one broadcastable shape; the parameters are numbers or tensors
    that broadcast with them.  ``psi``, the line's azimuth, goes through
    ``radians()`` as in the reference, so a caller passing radians gets
    the reference's numbers, not IEEE-738's.
    """
    Ta = fields["temperature"]
    Tfilm = (Ta + Ts) / 2
    T0 = 273.15
    psi_r = psi * (math.pi / 180.0)

    # forced convection (IEEE-738 eq. 3a/3b, 13a, 14a)
    V = fields["wnd100m"]
    mu = (1.458e-6 * Tfilm**1.5) / (Tfilm + 383.4 - T0)  # dynamic viscosity
    H = fields["height"]
    rho = (1.293 - 1.525e-4 * H + 6.379e-9 * H**2) / (1 + 0.00367 * (Tfilm - T0))
    reynold = D * V * rho / mu
    k = 2.424e-2 + 7.477e-5 * (Tfilm - T0) - 4.407e-9 * (Tfilm - T0) ** 2
    anglediff = fields["wnd_azimuth"] - psi_r
    Phi = torch.abs(torch.remainder(anglediff + math.pi / 2, math.pi) - math.pi / 2)
    K = 1.194 - torch.cos(Phi) + 0.194 * torch.cos(2 * Phi) + 0.368 * torch.sin(2 * Phi)

    Tdiff = Ts - Ta
    qcf1 = K * (1.01 + 1.347 * reynold**0.52) * k * Tdiff
    qcf2 = K * 0.754 * reynold**0.6 * k * Tdiff
    qcf = torch.maximum(qcf1, qcf2)

    # natural convection
    qcn = 3.645 * torch.sqrt(rho) * D**0.75 * Tdiff**1.25
    qc = torch.maximum(qcf, qcn)

    # radiated loss
    qr = 17.8 * D * epsilon * ((Ts / 100) ** 4 - (Ta / 100) ** 4)

    # solar gain (line-sun incidence)
    Q = fields["influx_direct"]
    Phi_s = torch.arccos(torch.cos(fields["solar_altitude"])
                         * torch.cos(fields["solar_azimuth"] - psi_r))
    qs = alpha * Q * (D * 1.0) * torch.sin(Phi_s)

    return torch.sqrt((qc + qr - qs) / R)


def batched_line_rating(cell_fields, mask, psi, R, D, Ts, epsilon, alpha):
    """Rating per line: the minimum of its cells' ampacity.

    cell_fields: dict of (L, K, T) tensors gathered per line (padded to K
    cells); mask: (L, K) bool validity; the parameters are (L,) arrays.
    Returns (L, T).  A NaN cell (e.g. a negative heat balance) is skipped,
    as the reference's ``min`` skips NaN; a line whose cells are all NaN,
    or that has no cell, is NaN.
    """
    ref = cell_fields["temperature"]
    mask = torch.as_tensor(mask, dtype=torch.bool, device=ref.device)

    def expand(p):
        return torch.as_tensor(p, dtype=ref.dtype, device=ref.device).reshape(-1, 1, 1)

    imax = ampacity(cell_fields, expand(psi), expand(R), expand(D), expand(Ts),
                    expand(epsilon), expand(alpha))
    imax = torch.where(mask[:, :, None] & ~torch.isnan(imax), imax, torch.inf)
    out = torch.amin(imax, dim=1)
    out = torch.where(torch.isinf(out), torch.nan, out)
    return torch.where(mask.any(dim=1)[:, None], out, torch.nan)
