"""GAN generators, discriminators and losses (port of
``physicsbasedfwi2_tpu/models/gan.py``: ``ResnetBlock``,
``ResnetGenerator``, ``NLayerDiscriminator``, ``PixelDiscriminator``,
``gan_loss``, ``gradient_penalty``, ``ImagePool``).

The nets take NHWC and return NHWC, as the Flax ones do; their strided
and 4x4 convs pad as Flax's ``padding="SAME"`` (``blocks.same_conv``),
which is asymmetric on even sizes.  GroupNorm has 8 groups (the
ResnetBlock's: :func:`blocks.num_groups_for`) at Flax's eps 1e-6.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicsbasedfwi2_tpu_torch.models.blocks import (
    dropout, group_norm, init_flax_like, resize_2x, same_conv,
)

D_SLOPE = 0.2  # the discriminators' LeakyReLU slope


class ResnetBlock(nn.Module):
    """x + GroupNorm(conv(dropout(ReLU(GroupNorm(conv(x)))))), SAME 3x3
    convs."""

    def __init__(self, features: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.convs = nn.ModuleList(same_conv(features, features, 3)
                                   for _ in range(2))
        self.norms = nn.ModuleList(group_norm(features) for _ in range(2))

    def forward(self, x, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        h = F.relu(self.norms[0](self.convs[0](x)))
        h = dropout(h, self.dropout, deterministic=deterministic,
                    generator=generator)
        return x + self.norms[1](self.convs[1](h))


class ResnetGenerator(nn.Module):
    """The resnet_9blocks / resnet_6blocks generator: a 7x7 conv to
    ``base``, two stride-2 3x3 convs to 4 ``base``, ``n_blocks``
    :class:`ResnetBlock`, two bilinear 2x upsamples each with a 3x3 conv
    (to 2 ``base``, then ``base``), a crop to the input's size and a 7x7
    conv to ``out_channels`` under tanh; GroupNorm(8) and ReLU after every
    conv but the last.  ``convs`` holds the five inner convs in order,
    ``head`` the last.  Returns the image alone (no latent), as Flax's."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 base: int = 64, n_blocks: int = 9, dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.convs = nn.ModuleList([
            same_conv(in_channels, base, 7),
            same_conv(base, 2 * base, 3, stride=2),
            same_conv(2 * base, 4 * base, 3, stride=2),
            same_conv(4 * base, 2 * base, 3),
            same_conv(2 * base, base, 3)])
        self.norms = nn.ModuleList(group_norm(c, 8) for c in
                                   (base, 2 * base, 4 * base, 2 * base, base))
        self.resblocks = nn.ModuleList(ResnetBlock(4 * base, dropout)
                                       for _ in range(n_blocks))
        self.head = same_conv(base, out_channels, 7)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, x, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        h_in, w_in = x.shape[1:3]
        h = x.permute(0, 3, 1, 2)
        for conv, norm in zip(self.convs[:3], self.norms[:3]):
            h = F.relu(norm(conv(h)))
        for block in self.resblocks:
            h = block(h, deterministic=deterministic, generator=generator)
        for conv, norm in zip(self.convs[3:], self.norms[3:]):
            h = F.relu(norm(conv(resize_2x(h))))
        h = self.head(h[:, :, :h_in, :w_in])
        return torch.tanh(h).permute(0, 2, 3, 1)


class NLayerDiscriminator(nn.Module):
    """The 70x70 PatchGAN: a stride-2 4x4 conv to ``base``, ``n_layers - 1``
    stride-2 4x4 convs doubling the width (at most 8 ``base``) with
    GroupNorm(8), a stride-1 4x4 conv with GroupNorm(8), LeakyReLU(0.2)
    after each, and a stride-1 4x4 conv to one channel (``head``); every
    conv SAME-padded as Flax pads it."""

    def __init__(self, in_channels: int, base: int = 64, n_layers: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = [base]
        for _ in range(n_layers):
            widths.append(min(widths[-1] * 2, base * 8))
        self.convs = nn.ModuleList(
            [same_conv(in_channels, base, 4, stride=2)]
            + [same_conv(cin, cout, 4, stride=2)
               for cin, cout in zip(widths[:n_layers - 1], widths[1:n_layers])]
            + [same_conv(widths[n_layers - 1], widths[n_layers], 4)])
        self.norms = nn.ModuleList(group_norm(c, 8) for c in widths[1:])
        self.head = same_conv(widths[n_layers], 1, 4)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, x):
        h = F.leaky_relu(self.convs[0](x.permute(0, 3, 1, 2)), D_SLOPE)
        for conv, norm in zip(self.convs[1:], self.norms):
            h = F.leaky_relu(norm(conv(h)), D_SLOPE)
        return self.head(h).permute(0, 2, 3, 1)


class PixelDiscriminator(nn.Module):
    """The 1x1 pixel-wise discriminator: 1x1 convs to ``base``
    (LeakyReLU(0.2)), to 2 ``base`` (GroupNorm(8), LeakyReLU(0.2)) and to
    one channel (``head``)."""

    def __init__(self, in_channels: int, base: int = 64,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(in_channels, base, 1),
                                    nn.Conv2d(base, 2 * base, 1)])
        self.norms = nn.ModuleList([group_norm(2 * base, 8)])
        self.head = nn.Conv2d(2 * base, 1, 1)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, x):
        h = F.leaky_relu(self.convs[0](x.permute(0, 3, 1, 2)), D_SLOPE)
        h = F.leaky_relu(self.norms[0](self.convs[1](h)), D_SLOPE)
        return self.head(h).permute(0, 2, 3, 1)


def gan_loss(pred: torch.Tensor, target_is_real: bool,
             mode: str = "lsgan") -> torch.Tensor:
    """The GAN loss of discriminator output ``pred``: "lsgan" (mean squared
    error to 1 or 0), "vanilla" (binary cross-entropy with logits, in the
    stable form max(p, 0) - p t + log1p(exp(-|p|))) or "wgangp" (minus or
    plus the mean)."""
    if mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return torch.mean((pred - target) ** 2)
    if mode == "vanilla":
        target = 1.0 if target_is_real else 0.0
        # torch.maximum splits the gradient at a tie, as jnp.maximum does
        return torch.mean(torch.maximum(pred, torch.zeros_like(pred))
                          - pred * target
                          + torch.log1p(torch.exp(-pred.abs())))
    if mode == "wgangp":
        return -torch.mean(pred) if target_is_real else torch.mean(pred)
    raise ValueError(f"unknown gan mode {mode!r}")


def penalty_alpha(shape, generator: torch.Generator | None,
                  device) -> torch.Tensor:
    """The WGAN-GP mixing weights: uniform [0, 1) of ``shape`` from
    ``generator`` (on ``device``)."""
    return torch.rand(shape, generator=generator, device=device)


def gradient_penalty(disc, real: torch.Tensor, fake: torch.Tensor,
                     generator: torch.Generator | None = None,
                     mode: str = "mixed",
                     constant: float = 1.0) -> torch.Tensor:
    """The WGAN-GP penalty mean((|d disc(x).sum() / dx| - constant)^2) over
    the batch, x the real images ("real"), the fake ones ("fake") or, by
    default, alpha real + (1 - alpha) fake with one alpha per sample
    (:func:`penalty_alpha` from ``generator``).  Differentiable in
    ``disc``'s parameters (the input gradient is taken with
    ``create_graph=True``)."""
    if mode == "real":
        interp = real
    elif mode == "fake":
        interp = fake
    else:
        alpha = penalty_alpha((real.shape[0], 1, 1, 1), generator,
                              real.device)
        interp = alpha * real + (1 - alpha) * fake
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(disc(interp).sum(), interp,
                                   create_graph=True)
    norms = torch.sqrt(torch.sum(grads ** 2, dim=(1, 2, 3)) + 1e-16)
    return torch.mean((norms - constant) ** 2)


class ImagePool:
    """History buffer of generated images for the discriminator: the first
    ``pool_size`` images pass through and are kept; after that each image,
    with probability 1/2, is swapped for a random kept one (which it
    replaces in the pool), else passes through.  The draws come from
    ``numpy.random.default_rng(seed)``, as the JAX package's.  Takes and
    returns a numpy array or a tensor (kept on its device, detached)."""

    def __init__(self, pool_size: int = 50, seed: int = 0):
        self.pool_size = pool_size
        self.images: list = []
        self._rng = np.random.default_rng(seed)

    def query(self, images):
        if self.pool_size == 0:
            return images
        tensor = isinstance(images, torch.Tensor)
        rows = images.detach() if tensor else np.asarray(images)
        copy = (lambda a: a.clone()) if tensor else (lambda a: a.copy())
        out = []
        for img in rows:
            if len(self.images) < self.pool_size:
                self.images.append(copy(img) if tensor else img)
                out.append(img)
            elif self._rng.random() > 0.5:
                idx = int(self._rng.integers(0, self.pool_size))
                out.append(copy(self.images[idx]))
                self.images[idx] = copy(img) if tensor else img
            else:
                out.append(img)
        return torch.stack(out) if tensor else np.stack(out)
