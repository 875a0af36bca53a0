"""PML absorbing-boundary damping profiles (port of
``physicsbasedfwi2_tpu/ops/pml.py``)."""

from __future__ import annotations

import math

import torch


def sigma_profile(n: int, width_lo: int, width_hi: int, dx: float,
                  vmax: float, *, power: int = 2, refl: float = 1e-4,
                  half_cell: bool = False,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """1D PML damping profile sigma(x) >= 0 of length ``n`` (float32).

    sigma rises polynomially from 0 at the interior edge to
    sigma_max = -(p+1) * vmax * ln(R) / (2 * L) at the outer edge.

    Args:
        width_lo / width_hi: PML thickness (cells) at the low/high end
            (0 disables that side, e.g. a free surface).
        half_cell: evaluate at staggered positions (i + 1/2).
    """
    x = torch.arange(n, dtype=torch.float32, device=device)
    if half_cell:
        x = x + 0.5
    sigma = torch.zeros(n, dtype=torch.float32, device=device)
    if width_lo > 0:
        L = width_lo * dx
        smax = -(power + 1) * vmax * math.log(refl) / (2.0 * L)
        d = torch.clamp((width_lo - x) * dx, 0.0, L)
        sigma = sigma + smax * (d / L) ** power
    if width_hi > 0:
        L = width_hi * dx
        smax = -(power + 1) * vmax * math.log(refl) / (2.0 * L)
        d = torch.clamp((x - (n - 1 - width_hi)) * dx, 0.0, L)
        sigma = sigma + smax * (d / L) ** power
    return sigma


def damping_factors(sigma: torch.Tensor, dt: float) -> torch.Tensor:
    """Per-step exponential decay factor exp(-sigma * dt)."""
    return torch.exp(-sigma * dt)
