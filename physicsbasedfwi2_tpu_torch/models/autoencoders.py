"""Deep-image-prior autoencoder generator (port of
``physicsbasedfwi2_tpu/models/autoencoders.py``: ``AutoEncoderNet``,
the Auto22 family, and ``apply_velocity_output``).

Public interfaces are NHWC, as in the Flax nets: the encoder takes
shot gathers [B, nt, nr, num_shots] and the net returns the field
[B, nz, nx, C] in [0, 1] and the latent [B, latent_dim].  Inside, the
convolutions run in NCHW.  The encoder flattens in NHWC order and the
decoder's Dense output is read as [B, h0, w0, C], so Flax Dense kernels
carry over with a plain transpose (:mod:`models.convert`).
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

from physicsbasedfwi2_tpu_torch.models.blocks import (
    Down, Up, init_flax_like, pin_water, scale_to_range,
)


def _decode_start(out_hw: tuple[int, int], n_up: int) -> tuple[int, int]:
    """Smallest (h0, w0) with h0*2^n >= nz, w0*2^n >= nx (+1 margin
    for clean cropping)."""
    s = 2 ** n_up
    return (math.ceil(out_hw[0] / s) + 1, math.ceil(out_hw[1] / s) + 1)


def _encoded_hw(nt: int, nr: int, time_decimation: int,
                n_down: int) -> tuple[int, int]:
    h = -(-nt // time_decimation)
    w = nr
    for _ in range(n_down):
        h, w = h // 2, w // 2
    return h, w


class Decoder2D(nn.Module):
    """latent -> [B, nz, nx, out_channels] in [0, 1] (NHWC)."""

    def __init__(self, out_shape: tuple[int, int], out_channels: int = 1,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 latent_dim: int = 8, dropout: float = 0.0,
                 norm: str = "group"):
        super().__init__()
        self.out_shape = tuple(out_shape)
        n_up = len(filters) - 1
        self.h0, self.w0 = _decode_start(self.out_shape, n_up)
        self.top = filters[-1]
        self.fc = nn.Linear(latent_dim, self.h0 * self.w0 * self.top)
        chans = [filters[-1], *reversed(filters[:-1])]
        self.ups = nn.ModuleList(
            Up(cin, cout, norm, dropout) for cin, cout in zip(chans, chans[1:]))
        self.head = nn.Conv2d(filters[0], out_channels, 1)

    def forward(self, z):
        x = self.fc(z).reshape(-1, self.h0, self.w0, self.top)
        x = x.permute(0, 3, 1, 2)
        for up in self.ups:
            x = up(x)
        nz, nx = self.out_shape
        x = torch.sigmoid(self.head(x[:, :, :nz, :nx]))
        return x.permute(0, 2, 3, 1)


class Encoder2D(nn.Module):
    """Shot-gather encoder -> latent: time decimation, down blocks,
    NHWC flatten, Dense."""

    def __init__(self, in_shape: tuple[int, int, int], latent_dim: int = 8,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 time_decimation: int = 4, norm: str = "group"):
        super().__init__()
        nt, nr, n_in = in_shape
        self.time_decimation = time_decimation
        chans = [n_in, *filters]
        self.downs = nn.ModuleList(
            Down(cin, cout, norm) for cin, cout in zip(chans, chans[1:]))
        h, w = _encoded_hw(nt, nr, time_decimation, len(filters))
        self.fc = nn.Linear(h * w * filters[-1], latent_dim)

    def forward(self, shots):
        # shots: [B, nt, nr, num_shot_channels] (NHWC)
        x = shots[:, :: self.time_decimation].permute(0, 3, 1, 2)
        for down in self.downs:
            x = down(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc(x)


class AutoEncoderNet(nn.Module):
    """The deep-image-prior generator (Auto22): data -> latent
    bottleneck -> model map in [0, 1].

    ``in_shape`` is one sample's (nt, nr, num_shots): PyTorch sizes the
    encoder's Dense layer at construction, where Flax infers it at
    init.  Returns (field01 [B, nz, nx, C], latent [B, latent_dim]).
    """

    def __init__(self, out_shape: tuple[int, int],
                 in_shape: tuple[int, int, int], out_channels: int = 1,
                 latent_dim: int = 8,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 time_decimation: int = 4, use_cbam: bool = False,
                 dropout: float = 0.0, norm: str = "group",
                 generator: torch.Generator | None = None):
        super().__init__()
        if use_cbam:
            raise NotImplementedError(
                "use_cbam (Auto22CBAM) is not ported yet (ROADMAP Queue A, "
                "item 11)")
        self.encoder = Encoder2D(in_shape, latent_dim, filters,
                                 time_decimation, norm)
        self.decoder = Decoder2D(out_shape, out_channels, filters, latent_dim,
                                 dropout, norm)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, shots):
        z = self.encoder(shots)
        return self.decoder(z), z


def apply_velocity_output(field01, true_model, *, vmin=None, vmax=None,
                          water_vel: float = 1500.0):
    """Output transform: [0,1] -> [vmin, vmax] with water cells pinned
    (vmin/vmax default to the true model's range)."""
    if vmin is None:
        vmin = torch.min(true_model)
    if vmax is None:
        vmax = torch.max(true_model)
    v = scale_to_range(field01, vmin, vmax)
    return pin_water(v, true_model, water_vel)
