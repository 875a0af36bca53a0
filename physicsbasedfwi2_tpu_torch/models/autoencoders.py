"""Deep-image-prior autoencoder generators (port of
``physicsbasedfwi2_tpu/models/autoencoders.py``: ``AutoEncoderNet``, the
Auto22 family with its CBAM variant, ``FlowAutoEncoderNet`` (AutoNF),
``ElasticAutoEncoderNet``, the AutoElMar22 family, ``ModelParamNet``,
and the output transforms ``apply_velocity_output`` and
``apply_elastic_output``).

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
    CBAM, Down, Up, init_flax_like, pin_water, scale_to_range,
)
from physicsbasedfwi2_tpu_torch.models.flows import LatentFlow


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
    """latent -> [B, nz, nx, out_channels] (NHWC), through a final
    ``sigmoid`` (in [0, 1]), ``tanh`` or no activation (``none``).  Each
    up block ends in dropout at ``dropout`` (masks from ``generator``
    unless ``deterministic``), then :class:`CBAM` with ``use_cbam``."""

    def __init__(self, out_shape: tuple[int, int], out_channels: int = 1,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 latent_dim: int = 8, dropout: float = 0.0,
                 norm: str = "group", final_activation: str = "sigmoid",
                 use_cbam: bool = False):
        super().__init__()
        if final_activation not in ("sigmoid", "tanh", "none"):
            raise ValueError(f"final_activation {final_activation!r}")
        self.final_activation = final_activation
        self.out_shape = tuple(out_shape)
        n_up = len(filters) - 1
        self.h0, self.w0 = _decode_start(self.out_shape, n_up)
        self.top = filters[-1]
        self.fc = nn.Linear(latent_dim, self.h0 * self.w0 * self.top)
        chans = [filters[-1], *reversed(filters[:-1])]
        self.ups = nn.ModuleList(
            Up(cin, cout, norm, dropout) for cin, cout in zip(chans, chans[1:]))
        self.cbams = (nn.ModuleList(CBAM(c) for c in chans[1:]) if use_cbam
                      else None)
        self.head = nn.Conv2d(filters[0], out_channels, 1)

    def forward(self, z, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        x = self.fc(z).reshape(-1, self.h0, self.w0, self.top)
        x = x.permute(0, 3, 1, 2)
        for i, up in enumerate(self.ups):
            x = up(x, deterministic=deterministic, generator=generator)
            if self.cbams is not None:
                x = self.cbams[i](x)
        nz, nx = self.out_shape
        x = self.head(x[:, :, :nz, :nx])
        if self.final_activation == "sigmoid":
            x = torch.sigmoid(x)
        elif self.final_activation == "tanh":
            x = torch.tanh(x)
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
    init.  Returns (field01 [B, nz, nx, C], latent [B, latent_dim]);
    ``deterministic`` and ``generator`` go to the decoder's dropout;
    ``use_cbam`` (Auto22CBAM) puts CBAM after each decoder up block.
    """

    def __init__(self, out_shape: tuple[int, int],
                 in_shape: tuple[int, int, int], out_channels: int = 1,
                 latent_dim: int = 8,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 time_decimation: int = 4, use_cbam: bool = False,
                 dropout: float = 0.0, norm: str = "group",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = Encoder2D(in_shape, latent_dim, filters,
                                 time_decimation, norm)
        self.decoder = Decoder2D(out_shape, out_channels, filters, latent_dim,
                                 dropout, norm, use_cbam=use_cbam)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, shots, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        z = self.encoder(shots)
        return self.decoder(z, deterministic=deterministic,
                            generator=generator), z


class FlowAutoEncoderNet(nn.Module):
    """Autoencoder with an invertible head on the latent (AutoNF): the
    encoder's latent passes through :class:`LatentFlow`
    (``LATENT_FLOW_BLOCKS`` affine couplings) before the decoder.
    ``in_shape`` is one sample's (nt, nr, num_shots).  Returns (field01
    [B, nz, nx, C], z_flow [B, latent_dim], log|det| [B]);
    ``reverse=True`` runs the flow inverted."""

    def __init__(self, out_shape: tuple[int, int],
                 in_shape: tuple[int, int, int], out_channels: int = 1,
                 latent_dim: int = 8,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 time_decimation: int = 4, norm: str = "group",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = Encoder2D(in_shape, latent_dim, filters,
                                 time_decimation, norm)
        self.flow = LatentFlow(latent_dim)
        self.decoder = Decoder2D(out_shape, out_channels, filters, latent_dim,
                                 norm=norm)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, shots, *, deterministic: bool = True,
                generator: torch.Generator | None = None,
                reverse: bool = False):
        z, logdet = self.flow(self.encoder(shots), reverse=reverse)
        out = self.decoder(z, deterministic=deterministic,
                           generator=generator)
        return out, z, logdet


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ElasticAutoEncoderNet(nn.Module):
    """Two-component elastic generator (AutoElMar22): the vx and vz
    gathers are each combined by a 1x1 conv into 4 channels, share one
    encoder -> latent, and decode through one branch per field (vp, vs
    [, rho]); the outputs are deltas added to the low-frequency model
    by :func:`apply_elastic_output`.

    head="linear": the decoder's raw output is the delta (no final
    activation); head="tanh": deltas in [-1, 1].  ``in_shape`` is one
    sample's (nt, nr, num_shots).  Returns (deltas [B, nz, nx,
    n_fields], latent [B, latent_dim]).  Only the decoders carry dropout
    (``deterministic`` and ``generator`` go to them): :meth:`decode` of
    one latent repeated n times draws n independent dropout samples.
    """

    def __init__(self, out_shape: tuple[int, int],
                 in_shape: tuple[int, int, int], n_fields: int = 2,
                 latent_dim: int = 8,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 time_decimation: int = 4, dropout: float = 0.0,
                 norm: str = "group", head: str = "tanh",
                 generator: torch.Generator | None = None):
        super().__init__()
        nt, nr, ns = in_shape
        self.n_fields = n_fields
        self.combine_vx = nn.Conv2d(ns, 4, 1)
        self.combine_vz = nn.Conv2d(ns, 4, 1)
        self.encoder = Encoder2D((nt, nr, 8), latent_dim, filters,
                                 time_decimation, norm)
        act = "tanh" if head == "tanh" else "none"
        # attribute names follow the Flax submodules (decoder_field{k})
        self.field_names = [f"decoder_field{k}" for k in range(n_fields)]
        for name in self.field_names:
            setattr(self, name, Decoder2D(out_shape, 1, filters, latent_dim,
                                          dropout, norm,
                                          final_activation=act))
        if generator is not None:
            init_flax_like(self, generator)

    def encode(self, shots_vx, shots_vz):
        """The latent [B, latent_dim] of the vx and vz gathers."""
        x = torch.cat([_conv_nhwc(self.combine_vx, shots_vx),
                       _conv_nhwc(self.combine_vz, shots_vz)], dim=-1)
        return self.encoder(x)

    def decode(self, z, *, deterministic: bool = True,
               generator: torch.Generator | None = None):
        """The deltas [B, nz, nx, n_fields] of the latents ``z``."""
        return torch.cat([getattr(self, n)(z, deterministic=deterministic,
                                           generator=generator)
                          for n in self.field_names], dim=-1)

    def forward(self, shots_vx, shots_vz, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        z = self.encode(shots_vx, shots_vz)
        return self.decode(z, deterministic=deterministic,
                           generator=generator), z


class ModelParamNet(nn.Module):
    """"Classic FWI" pseudo-net (ref AutoEl22N via define_G1,
    networks.py:6477-6520): its one parameter ``model`` is the model
    grids [nz, nx, n_fields], a copy of ``init_model``, and the forward
    returns them as [1, nz, nx, n_fields], so a training loop over it is
    plain adjoint FWI with no reparameterization."""

    def __init__(self, init_model):
        super().__init__()
        self.model = nn.Parameter(
            torch.as_tensor(init_model, dtype=torch.float32).clone())

    def forward(self):
        return self.model[None]


class _ClipSTE(torch.autograd.Function):
    """Hard clip forward, identity backward (straight-through)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def apply_elastic_output(deltas, lowf, true_model, *, delta_scale,
                         clip_min, clip_max, pin_rows: int = 0,
                         clip_mode: str = "hard"):
    """Elastic output transform: per-field deltas scaled and added to
    the low-frequency model, clipped to physical bounds, top (water)
    rows pinned to the true model.

    Args:
        deltas, lowf, true_model: [B, nz, nx, F] (only the true model's
            top rows are used).
        delta_scale, clip_min, clip_max: [F] per-field scale and bounds.
        pin_rows: number of top rows pinned.
        clip_mode: "hard" zeroes the gradient of out-of-bounds cells;
            "ste" keeps the hard clip forward but passes the gradient
            straight through it.
    """
    def vec(v):
        return torch.as_tensor(v, dtype=deltas.dtype,
                               device=deltas.device)[None, None, None, :]

    m = lowf + deltas * vec(delta_scale)
    lo, hi = vec(clip_min), vec(clip_max)
    if clip_mode == "ste":
        m = _ClipSTE.apply(m, lo, hi)
    else:
        m = torch.minimum(torch.maximum(m, lo), hi)
    if pin_rows > 0:
        row = torch.arange(m.shape[1], device=m.device)[None, :, None, None]
        m = torch.where(row < pin_rows, true_model, m)
    return m


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
