"""Standard-atmosphere model (counterpart of neuralplane_tpu/ops/atmosphere.py).

US units: ft, ft/s, slug/ft^3, lbf/ft^2.
"""
from __future__ import annotations

import torch

RHO0 = 2.377e-3          # sea-level density (slug/ft^3)
GAMMA_R = 1.4 * 1716.3   # gamma * R for air (ft.lbf/slug/R)


def atmos(alt: torch.Tensor, vt: torch.Tensor):
    """Mach number, dynamic pressure qbar, static pressure ps at altitude.

    Temperature lapse to the 35 kft tropopause, isothermal 390 R above.
    """
    tfac = 1.0 - 0.703e-5 * alt
    temp = torch.where(alt >= 35000.0, 390.0, 519.0 * tfac)
    rho = RHO0 * torch.pow(tfac, 4.14)
    mach = vt / torch.sqrt(GAMMA_R * temp)
    qbar = 0.5 * rho * vt * vt
    ps = 1715.0 * rho * temp
    ps = torch.where(ps == 0.0, 1715.0, ps)
    return mach, qbar, ps


def eas2tas(alt: torch.Tensor) -> torch.Tensor:
    """EAS->TAS conversion factor sqrt(rho0/rho) from altitude (ft)."""
    tfac = 1.0 - 0.703e-5 * alt
    return torch.sqrt(1.0 / torch.pow(tfac, 4.14))
