"""Fourier neural operator blocks (port of
``physicsbasedfwi2_tpu/models/fno.py``: ``SpectralConv1d``,
``SpectralConv2d``, ``FNOBlock2d``, ``FNO2d`` and ``lp_loss``).

The spectral convs keep Flax's parameter layout, the real and imaginary
parts as separate parameters (``w_real``/``w_imag`` [modes, in, out];
``w{1,2}_{real,imag}`` [modes1, modes2, in, out]), and work in PyTorch's
layout (NCL, NCHW); ``FNO2d`` takes and returns NHWC.  The FFTs are
``torch.fft``'s (cuFFT on a card).  GELU is the tanh approximation,
``flax.linen.gelu``'s default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from physicsbasedfwi2_tpu_torch.models.blocks import init_flax_like


def _normal_(p: torch.Tensor, std: float,
             generator: torch.Generator | None) -> None:
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=generator) * std)


class SpectralConv1d(nn.Module):
    """1D spectral convolution of NCL input: the lowest ``modes`` Fourier
    modes times complex weights [modes, in, features], the rest zero.
    Weights initialized normal with std 1 / in_channels, as Flax's."""

    def __init__(self, in_channels: int, features: int, modes: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.modes = modes
        shape = (modes, in_channels, features)
        self.w_real = nn.Parameter(torch.empty(shape))
        self.w_imag = nn.Parameter(torch.empty(shape))
        for p in (self.w_real, self.w_imag):
            _normal_(p, 1.0 / in_channels, generator)

    def forward(self, x):
        b, _, length = x.shape
        w = torch.complex(self.w_real, self.w_imag)
        xf = torch.fft.rfft(x, dim=-1)
        out = xf.new_zeros((b, w.shape[-1], xf.shape[-1]))
        out[:, :, :self.modes] = torch.einsum(
            "bcm,mcf->bfm", xf[:, :, :self.modes], w)
        return torch.fft.irfft(out, n=length, dim=-1)


class SpectralConv2d(nn.Module):
    """2D spectral convolution of NCHW input: of the rfft2 modes, the
    first ``modes1`` rows and the last ``modes1`` rows (each at the first
    ``modes2`` columns) times complex weights w1 and w2 [modes1, modes2, in,
    features], the rest zero; where the two blocks overlap (fewer than 2
    ``modes1`` rows) the last rows' block wins, as Flax's ``.at[].set``
    order does."""

    def __init__(self, in_channels: int, features: int, modes1: int,
                 modes2: int, generator: torch.Generator | None = None):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        shape = (modes1, modes2, in_channels, features)
        for name in ("w1_real", "w1_imag", "w2_real", "w2_imag"):
            p = nn.Parameter(torch.empty(shape))
            _normal_(p, 1.0 / in_channels, generator)
            setattr(self, name, p)

    def forward(self, x):
        b, _, h, w = x.shape
        m1, m2 = self.modes1, self.modes2
        w1 = torch.complex(self.w1_real, self.w1_imag)
        w2 = torch.complex(self.w2_real, self.w2_imag)
        xf = torch.fft.rfft2(x)
        out = xf.new_zeros((b, w1.shape[-1], h, w // 2 + 1))
        out[:, :, :m1, :m2] = torch.einsum("bcxy,xycf->bfxy",
                                           xf[:, :, :m1, :m2], w1)
        out[:, :, -m1:, :m2] = torch.einsum("bcxy,xycf->bfxy",
                                            xf[:, :, -m1:, :m2], w2)
        return torch.fft.irfft2(out, s=(h, w))


class FNOBlock2d(nn.Module):
    """GELU(spectral conv + 1x1 conv) of NCHW input."""

    def __init__(self, features: int, modes1: int = 12, modes2: int = 12,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spectral = SpectralConv2d(features, features, modes1, modes2,
                                       generator)
        self.conv = nn.Conv2d(features, features, 1)

    def forward(self, x):
        return F.gelu(self.spectral(x) + self.conv(x), approximate="tanh")


class FNO2d(nn.Module):
    """Stacked FNO for image-to-image operator learning: a 1x1 lift to
    ``width``, ``depth`` :class:`FNOBlock2d` at ``modes`` x ``modes``, a 1x1
    conv to 128 under GELU and a 1x1 conv to ``out_channels`` (``head``).
    NHWC in, (NHWC, None) out."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 width: int = 32, depth: int = 4, modes: int = 12,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(in_channels, width, 1),
                                    nn.Conv2d(width, 128, 1)])
        self.fnos = nn.ModuleList(FNOBlock2d(width, modes, modes, generator)
                                  for _ in range(depth))
        self.head = nn.Conv2d(128, out_channels, 1)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, x, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        h = self.convs[0](x.permute(0, 3, 1, 2))
        for block in self.fnos:
            h = block(h)
        h = F.gelu(self.convs[1](h), approximate="tanh")
        return self.head(h).permute(0, 2, 3, 1), None


def lp_loss(pred: torch.Tensor, target: torch.Tensor, p: int = 2, *,
            relative: bool = True, eps: float = 1e-12) -> torch.Tensor:
    """The batch mean of each sample's Lp distance, over the target's Lp
    norm (+ ``eps``) when ``relative``."""
    flat_p = pred.reshape(pred.shape[0], -1)
    flat_t = target.reshape(target.shape[0], -1)
    diff = torch.sum((flat_p - flat_t).abs() ** p, dim=1) ** (1.0 / p)
    if relative:
        norm = torch.sum(flat_t.abs() ** p, dim=1) ** (1.0 / p)
        return torch.mean(diff / (norm + eps))
    return torch.mean(diff)
