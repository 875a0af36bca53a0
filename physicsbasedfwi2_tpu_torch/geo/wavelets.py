"""Source wavelets (port of ``physicsbasedfwi2_tpu/geo/wavelets.py``).

Replaces ``deepwave.wavelets.ricker`` (peak frequency f, length nt,
sample dt, peak time shift 1/f).
"""

from __future__ import annotations

import math

import torch


def ricker(freq: float, nt: int, dt: float, peak_time: float | None = None,
           *, device: torch.device | str = "cpu") -> torch.Tensor:
    """Ricker (Mexican-hat) wavelet, [nt] float32.

    Computed in float32 throughout, as the JAX package computes it (its
    float64 ``arange`` is truncated to float32 with x64 off), so the two
    agree to the last bit or so.
    """
    if peak_time is None:
        peak_time = 1.0 / freq
    t = torch.arange(nt, dtype=torch.float32, device=device) * dt - peak_time
    a = (math.pi * freq * t) ** 2
    return (1.0 - 2.0 * a) * torch.exp(-a)
