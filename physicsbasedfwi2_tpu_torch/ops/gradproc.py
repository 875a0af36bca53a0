"""Gradient post-processing for FWI model gradients (port of
``physicsbasedfwi2_tpu/ops/gradproc.py``, the slice the acoustic
engine uses): depth^2 weighting and the water mask."""

from __future__ import annotations

import torch


def depth_weighting(grad: torch.Tensor, power: float = 2.0) -> torch.Tensor:
    """Multiply each row by depth_index**power."""
    nz = grad.shape[-2]
    w = torch.arange(nz, dtype=grad.dtype, device=grad.device) ** power
    return grad * w[..., :, None]


def water_mask(grad: torch.Tensor, reference_model: torch.Tensor,
               water_vel: float = 1500.0) -> torch.Tensor:
    """Zero the gradient wherever the true/initial model is water."""
    return torch.where(reference_model == water_vel,
                       torch.zeros_like(grad), grad)
