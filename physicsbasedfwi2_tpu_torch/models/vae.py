"""Variational autoencoder generators (port of
``physicsbasedfwi2_tpu/models/vae.py``): ``VaeNet`` (the Vae, Vae2 and
VaeLatent* names: shot gathers -> posterior (mu, logvar) -> decoder),
``VaeFlowNet`` (VaeNormalizing*: the posterior sample sharpened by planar
flows), ``ModelVae`` (VaeNoPhy, Vaevel: a velocity-model VAE) and the
standard-normal ``kl_divergence``.

The encoder emits ``2 * latent_dim`` values, split into (mu, logvar).
With ``deterministic`` the latent is mu; otherwise it is the
reparameterized sample mu + exp(logvar / 2) * eps, eps drawn by
:func:`latent_noise` from the caller's ``torch.Generator``.  Every net
has ``decode`` (the decoder alone, for frozen-decoder latent inversion).
Public interfaces are NHWC, as in :mod:`autoencoders`.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from physicsbasedfwi2_tpu_torch.models.autoencoders import (
    Decoder2D, Encoder2D, _encoded_hw,
)
from physicsbasedfwi2_tpu_torch.models.blocks import Down, init_flax_like
from physicsbasedfwi2_tpu_torch.models.flows import PlanarFlowStack


def latent_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard-normal noise of ``shape`` (float32) from ``generator``, on
    its device: the reparameterization's eps."""
    return torch.randn(shape, generator=generator, device=generator.device)


def _sample(mu, logvar, deterministic: bool, generator):
    if deterministic:
        return mu
    if generator is None:
        raise ValueError("a VAE decode with deterministic=False needs a "
                         "torch.Generator")
    return mu + torch.exp(0.5 * logvar) * latent_noise(mu.shape, generator)


class VaeNet(nn.Module):
    """VAE generator over shot gathers ``in_shape`` = (nt, nr, num_shots):
    returns (field01 [B, nz, nx, C], mu, logvar, z)."""

    def __init__(self, out_shape: tuple[int, int],
                 in_shape: tuple[int, int, int], out_channels: int = 1,
                 latent_dim: int = 8,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 time_decimation: int = 4, norm: str = "group",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.latent_dim = latent_dim
        self.encoder = Encoder2D(in_shape, 2 * latent_dim, filters,
                                 time_decimation, norm)
        self.decoder = Decoder2D(out_shape, out_channels, filters, latent_dim,
                                 norm=norm)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, shots, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        mu, logvar = self.encoder(shots).chunk(2, dim=-1)
        z = _sample(mu, logvar, deterministic, generator)
        return self.decode(z), mu, logvar, z

    def decode(self, z):
        return self.decoder(z)


class _ImgEncoder(nn.Module):
    """Image [B, H, W, C] -> 2 * latent_dim (mu, logvar): down blocks,
    NHWC flatten, Dense."""

    def __init__(self, in_shape: tuple[int, int, int], latent_dim: int,
                 filters: Sequence[int], norm: str = "group"):
        super().__init__()
        h, w, c = in_shape
        chans = [c, *filters]
        self.downs = nn.ModuleList(
            Down(cin, cout, norm) for cin, cout in zip(chans, chans[1:]))
        h, w = _encoded_hw(h, w, 1, len(filters))
        self.fc = nn.Linear(h * w * filters[-1], 2 * latent_dim)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for down in self.downs:
            x = down(x)
        return self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class ModelVae(nn.Module):
    """Velocity-model VAE for generative pretraining (VaeNoPhy, Vaevel):
    image ``in_shape`` = (H, W, C) -> latent -> image.  Returns (recon01
    [B, nz, nx, C], mu, logvar, z)."""

    def __init__(self, out_shape: tuple[int, int],
                 in_shape: tuple[int, int, int], out_channels: int = 1,
                 latent_dim: int = 8,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 norm: str = "group",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.latent_dim = latent_dim
        self.encoder = _ImgEncoder(in_shape, latent_dim, filters, norm)
        self.decoder = Decoder2D(out_shape, out_channels, filters, latent_dim,
                                 norm=norm)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, model_img, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        mu, logvar = self.encoder(model_img).chunk(2, dim=-1)
        z = _sample(mu, logvar, deterministic, generator)
        return self.decode(z), mu, logvar, z

    def decode(self, z):
        return self.decoder(z)


class VaeFlowNet(nn.Module):
    """VAE whose posterior sample z0 passes through ``PLANAR_FLOWS`` planar
    flows (VaeNormalizing, VaeNormalizingPhy): returns (field01, mu,
    logvar, z_K, log|det| [B]); the ELBO's KL term becomes KL(q0 ||
    N(0, 1)) - E[logdet]."""

    def __init__(self, out_shape: tuple[int, int],
                 in_shape: tuple[int, int, int], out_channels: int = 1,
                 latent_dim: int = 8,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 time_decimation: int = 4, norm: str = "group",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = Encoder2D(in_shape, 2 * latent_dim, filters,
                                 time_decimation, norm)
        self.flows = PlanarFlowStack(latent_dim, generator)
        self.decoder = Decoder2D(out_shape, out_channels, filters, latent_dim,
                                 norm=norm)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, shots, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        mu, logvar = self.encoder(shots).chunk(2, dim=-1)
        z_k, logdet = self.flows(_sample(mu, logvar, deterministic,
                                         generator))
        return self.decode(z_k), mu, logvar, z_k, logdet

    def decode(self, z):
        return self.decoder(z)


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, exp(logvar)) || N(0, 1)), summed over the latent and
    averaged over the batch."""
    return torch.mean(-0.5 * torch.sum(1 + logvar - mu ** 2
                                       - torch.exp(logvar), dim=-1))
