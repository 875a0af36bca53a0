"""Data-misfit functions (port of ``physicsbasedfwi2_tpu/ops/misfit.py``,
the slice the fused acoustic path uses)."""

from __future__ import annotations

import torch


def trace_normalize(d: torch.Tensor, *, time_axis: int = 1,
                    eps: float = 1e-10) -> torch.Tensor:
    """Divide each trace by its max |amplitude| over time.

    Layout [shots, nt, receivers], so the reduction runs over
    ``time_axis``.
    """
    m = torch.amax(torch.abs(d), dim=time_axis, keepdim=True)
    return d / (m + eps)


def l1_misfit(pred: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - obs))
