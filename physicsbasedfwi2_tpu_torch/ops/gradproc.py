"""Gradient post-processing for FWI model gradients (port of
``physicsbasedfwi2_tpu/ops/gradproc.py``, the slice the acoustic and
elastic engines use): depth^2 weighting, the water mask, the top-rows
taper, the per-field rescale to the model magnitude and the binomial
spatial smoothing."""

from __future__ import annotations

import math

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


def taper_top(grad: torch.Tensor, rows: int, *,
              smooth: int = 0) -> torch.Tensor:
    """Zero (optionally cosine-ramp) the top ``rows`` rows, the DENISE
    seabed mask."""
    nz = grad.shape[-2]
    z = torch.arange(nz, dtype=grad.dtype, device=grad.device)
    if smooth > 0:
        ramp = torch.clamp((z - rows) / smooth, 0.0, 1.0)
        w = 0.5 * (1 - torch.cos(math.pi * ramp))
    else:
        w = (z >= rows).to(grad.dtype)
    return grad * w[..., :, None]


def rescale_to_model(grad: torch.Tensor, model: torch.Tensor,
                     eps: float = 1e-20) -> torch.Tensor:
    """Scale so max|grad| matches max|model| (DENISE's per-field r1..r3
    step)."""
    r = torch.amax(torch.abs(model)) / (torch.amax(torch.abs(grad)) + eps)
    return grad * r


def smooth_spatial(grad: torch.Tensor, iters: int) -> torch.Tensor:
    """Separable binomial [1/4, 1/2, 1/4] smoothing of a [nz, nx]
    gradient, ``iters`` passes per axis, edge rows and columns replicated
    (DENISE's spatial gradient filter, for the point singularities at the
    source and receiver cells)."""
    for _ in range(iters):
        p = torch.cat([grad[:1], grad, grad[-1:]], 0)
        grad = 0.25 * p[:-2] + 0.5 * p[1:-1] + 0.25 * p[2:]
        p = torch.cat([grad[:, :1], grad, grad[:, -1:]], 1)
        grad = 0.25 * p[:, :-2] + 0.5 * p[:, 1:-1] + 0.25 * p[:, 2:]
    return grad
