"""Building blocks of the generator (port of
``physicsbasedfwi2_tpu/models/blocks.py``, the Auto22 slice).

The modules here work in NCHW, PyTorch's layout; the nets in
:mod:`autoencoders` take and return NHWC at their public interface,
as the Flax nets do.  Matching Flax: GroupNorm eps 1e-6, LeakyReLU
slope 0.1, SAME 3x3 convolutions, floor 2x2 average pooling, bilinear
2x resize with half-pixel centres, lecun-normal (truncated normal,
fan-in) kernels with zero biases from an explicit generator, and
``nn.Dropout``'s semantics (keep with probability 1 - rate, kept values
scaled by 1 / (1 - rate)) with the mask drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

GROUPNORM_EPS = 1e-6  # flax.linen.GroupNorm's default
LEAKY_SLOPE = 0.1
# std of a standard normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def num_groups_for(channels: int, cap: int = 8) -> int:
    """Largest divisor of `channels` that is <= cap (GroupNorm
    requires num_groups | channels)."""
    for g in range(min(cap, channels), 0, -1):
        if channels % g == 0:
            return g
    return 1


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> torch.Tensor:
    """Flax's lecun_normal: truncated normal on [-2, 2] std units,
    scaled to variance 1/fan_in."""
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return weight.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def init_flax_like(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize every conv and linear layer of ``module`` as Flax
    does: lecun-normal kernels, zero biases (norm layers keep their
    ones/zeros)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            nn.init.zeros_(m.bias)


def _norm(norm: str, features: int) -> nn.Module:
    if norm == "group":
        return nn.GroupNorm(num_groups_for(features), features,
                            eps=GROUPNORM_EPS)
    if norm == "none":
        return nn.Identity()
    raise NotImplementedError(
        f"norm={norm!r} is not ported yet (ROADMAP Queue A, item 8)")


def dropout_mask(x: torch.Tensor, keep: float,
                 generator: torch.Generator) -> torch.Tensor:
    """A boolean mask of ``x``'s shape, each element True with
    probability ``keep``, drawn from ``generator`` (on ``x``'s device)."""
    return torch.rand(x.shape, generator=generator, dtype=x.dtype,
                      device=x.device) < keep


def dropout(x: torch.Tensor, rate: float, *, deterministic: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Flax's ``nn.Dropout``: ``x`` itself when ``deterministic`` or
    ``rate`` is 0, zeros at rate 1, else each element kept with
    probability 1 - rate (:func:`dropout_mask`) and scaled by
    1 / (1 - rate)."""
    if deterministic or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a "
                         "torch.Generator")
    keep = 1.0 - rate
    return torch.where(dropout_mask(x, keep, generator), x / keep,
                       torch.zeros_like(x))


class ConvBlock(nn.Module):
    """Two SAME 3x3 convs, each with norm + LeakyReLU(0.1), then dropout
    at ``dropout`` (a mask from ``generator`` unless ``deterministic``)."""

    def __init__(self, in_channels: int, features: int, norm: str = "group",
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels, features, 3, padding=1),
            nn.Conv2d(features, features, 3, padding=1)])
        self.norms = nn.ModuleList([_norm(norm, features),
                                    _norm(norm, features)])

    def forward(self, x, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        for conv, norm in zip(self.convs, self.norms):
            x = F.leaky_relu(norm(conv(x)), LEAKY_SLOPE)
        return dropout(x, self.dropout, deterministic=deterministic,
                       generator=generator)


class Down(nn.Module):
    """ConvBlock then 2x2 average pool (floor)."""

    def __init__(self, in_channels: int, features: int, norm: str = "group",
                 dropout: float = 0.0):
        super().__init__()
        self.block = ConvBlock(in_channels, features, norm, dropout)

    def forward(self, x):
        return F.avg_pool2d(self.block(x), 2)


def resize_2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of NCHW (``jax.image.resize`` bilinear:
    half-pixel centres, edge samples clamped)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class Up(nn.Module):
    """Bilinear 2x upsample then ConvBlock."""

    def __init__(self, in_channels: int, features: int, norm: str = "group",
                 dropout: float = 0.0):
        super().__init__()
        self.block = ConvBlock(in_channels, features, norm, dropout)

    def forward(self, x, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        return self.block(resize_2x(x), deterministic=deterministic,
                          generator=generator)


def scale_to_range(x01: torch.Tensor, vmin, vmax) -> torch.Tensor:
    """Map sigmoid output [0,1] to [vmin, vmax]."""
    return vmin + x01 * (vmax - vmin)


def pin_water(model: torch.Tensor, true_model: torch.Tensor,
              water_vel: float = 1500.0) -> torch.Tensor:
    """Pin water cells to the known water velocity."""
    return torch.where(true_model == water_vel,
                       torch.full_like(model, water_vel), model)
