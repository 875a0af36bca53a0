"""The U-Net generator family (port of
``physicsbasedfwi2_tpu/models/unets.py``: ``UNet``, ``ASPPUNet``,
``ResUNetPlusPlus``, ``UNet3Plus``, ``MultiScaleUNet``, ``R2UNet`` with
``RecurrentConvBlock``).

Each net takes NHWC [B, H, W, in_channels] and returns (field [B, H', W',
out_channels], None), as the Flax nets do: with ``out_shape`` the output
is fitted to the model grid (:func:`fit_to_shape`; seismic in, velocity
out), else it keeps the input's size (image to image).  A submodule list
holds its modules in the order the Flax net creates them, so that the
i-th entry is Flax's ``<Type>_i`` (``models/convert.py``).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from physicsbasedfwi2_tpu_torch.models.blocks import (
    ASPP, CBAM, LEAKY_SLOPE, ConvBlock, ResidualConv, SqueezeExcite, UpCat,
    fit_to_shape, group_norm, init_flax_like, match_spatial, resize_2x,
    resize_to,
)


def _decoder(filters: Sequence[int], bottom: int, norm: str = "group"):
    """The UpCat stages from a ``bottom``-channel tensor up through
    ``reversed(filters)``, each onto its skip."""
    rev = list(reversed(filters))
    return nn.ModuleList(UpCat(cin, f, f, norm)
                         for cin, f in zip([bottom, *rev[:-1]], rev))


def _head(x, head: nn.Module, out_shape):
    """fit_to_shape (with ``out_shape``), the 1x1 head, sigmoid; NCHW in,
    (NHWC, None) out."""
    if out_shape is not None:
        x = fit_to_shape(x, out_shape)
    return torch.sigmoid(head(x)).permute(0, 2, 3, 1), None


class UNet(nn.Module):
    """Encoder-decoder with skip connections.  Each encoder stage is a
    ConvBlock (dropout at ``dropout``) then a floor 2x2 average pool; the
    bottleneck has ``2 * filters[-1]`` channels; each decoder stage is an
    :class:`UpCat` onto its skip, which passes through :class:`CBAM`
    first with ``use_attention`` (the Att name).  With ``out_shape`` the
    output is fitted to the model grid (:func:`fit_to_shape`: the
    Unet22 role, shot gathers in, velocity out), else it keeps the
    input's size.  A 1x1 conv and ``final_activation`` ("sigmoid",
    "tanh" or "none") end it.

    Takes NHWC [B, H, W, in_channels], at full resolution (no time
    decimation), and returns (field [B, H', W', out_channels], None).
    """

    def __init__(self, in_channels: int, out_channels: int = 1,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 out_shape: tuple[int, int] | None = None,
                 norm: str = "group", dropout: float = 0.0,
                 final_activation: str = "sigmoid",
                 use_attention: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if final_activation not in ("sigmoid", "tanh", "none"):
            raise ValueError(f"final_activation {final_activation!r}")
        self.final_activation = final_activation
        self.out_shape = None if out_shape is None else tuple(out_shape)
        chans = [in_channels, *filters]
        # the encoder's blocks, then the bottleneck's (Flax ConvBlock_0..n)
        self.blocks = nn.ModuleList(
            [ConvBlock(cin, cout, norm, dropout)
             for cin, cout in zip(chans, chans[1:])]
            + [ConvBlock(filters[-1], 2 * filters[-1], norm)])
        self.upcats = _decoder(filters, 2 * filters[-1], norm)
        self.cbams = (nn.ModuleList(CBAM(f) for f in reversed(filters))
                      if use_attention else None)
        self.head = nn.Conv2d(filters[0], out_channels, 1)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, x, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        x = x.permute(0, 3, 1, 2)
        skips = []
        for block in self.blocks[:-1]:
            x = block(x, deterministic=deterministic, generator=generator)
            skips.append(x)
            x = F.avg_pool2d(x, 2)
        x = self.blocks[-1](x)
        for i, (up, skip) in enumerate(zip(self.upcats, reversed(skips))):
            if self.cbams is not None:
                skip = self.cbams[i](skip)
            x = up(x, skip)
        if self.out_shape is not None:
            x = fit_to_shape(x, self.out_shape)
        x = self.head(x)
        if self.final_activation == "sigmoid":
            x = torch.sigmoid(x)
        elif self.final_activation == "tanh":
            x = torch.tanh(x)
        return x.permute(0, 2, 3, 1), None


class ASPPUNet(nn.Module):
    """U-Net whose bottleneck is an atrous pyramid (:class:`ASPP` on the
    last pooled level, at ``filters[-1]`` channels) in place of a
    ConvBlock; sigmoid output."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 out_shape: tuple[int, int] | None = None,
                 norm: str = "group",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_shape = None if out_shape is None else tuple(out_shape)
        chans = [in_channels, *filters]
        self.blocks = nn.ModuleList(ConvBlock(cin, cout, norm)
                                    for cin, cout in zip(chans, chans[1:]))
        self.aspp = ASPP(filters[-1], filters[-1])
        self.upcats = _decoder(filters, filters[-1], norm)
        self.head = nn.Conv2d(filters[0], out_channels, 1)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, x, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        x = x.permute(0, 3, 1, 2)
        skips = []
        for block in self.blocks:
            x = block(x)
            skips.append(x)
            x = F.avg_pool2d(x, 2)
        x = self.aspp(x)
        for up, skip in zip(self.upcats, reversed(skips)):
            x = up(x, skip)
        return _head(x, self.head, self.out_shape)


class ResUNetPlusPlus(nn.Module):
    """Residual U-Net: encoder :class:`ResidualConv` stages (stride 2 after
    the first, SAME padding) each followed by :class:`SqueezeExcite`, an
    :class:`ASPP` bridge, and decoder stages that upsample 2x, match the
    skip, concatenate [skip, x] and apply a ResidualConv (``res`` holds the
    encoder's stages, then the decoder's); sigmoid output."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 out_shape: tuple[int, int] | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_shape = None if out_shape is None else tuple(out_shape)
        self.depth = len(filters)
        chans = [in_channels, *filters]
        rev = list(reversed(filters))
        self.res = nn.ModuleList(
            [ResidualConv(cin, cout, 1 if i == 0 else 2)
             for i, (cin, cout) in enumerate(zip(chans, chans[1:]))]
            + [ResidualConv(f + cin, f) for cin, f in zip(rev, rev[1:])])
        self.ses = nn.ModuleList(SqueezeExcite(f) for f in filters)
        self.aspp = ASPP(filters[-1], filters[-1])
        self.head = nn.Conv2d(filters[0], out_channels, 1)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, x, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        # a standard-strided copy: the first GroupNorm normalizes the input
        # itself, and torch's CPU GroupNorm backward crashes on a
        # channels-last input (the NHWC permute) that needs no gradient
        x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
        skips = []
        for res, se in zip(self.res[:self.depth], self.ses):
            x = se(res(x))
            skips.append(x)
        x = self.aspp(x)
        for res, skip in zip(self.res[self.depth:], reversed(skips[:-1])):
            x = match_spatial(resize_2x(x), skip.shape[2], skip.shape[3])
            x = res(torch.cat([skip, x], dim=1))
        return _head(x, self.head, self.out_shape)


class UNet3Plus(nn.Module):
    """UNet 3+ with full-scale skips: each decoder stage (deepest first)
    maps every encoder level and the previous decoder output to its
    level's size (:func:`resize_to`: antialiased where it shrinks), a SAME
    3x3 conv to ``cat_channels`` each, and a ConvBlock over their
    concatenation, ``cat_channels * (depth + 1)`` wide.  ``blocks`` holds
    the encoder's ConvBlocks, the bottom's, then the decoder's; ``convs``
    the aggregation convs, stage by stage, the previous decoder output's
    last in each; sigmoid output."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 out_shape: tuple[int, int] | None = None,
                 norm: str = "group", cat_channels: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_shape = None if out_shape is None else tuple(out_shape)
        n = self.depth = len(filters)
        wide = cat_channels * (n + 1)
        chans = [in_channels, *filters]
        self.blocks = nn.ModuleList(
            [ConvBlock(cin, cout, norm) for cin, cout in zip(chans, chans[1:])]
            + [ConvBlock(filters[-1], 2 * filters[-1], norm)]
            + [ConvBlock(wide, wide, norm) for _ in filters])
        self.convs = nn.ModuleList(
            nn.Conv2d(c, cat_channels, 3, padding=1)
            for j in range(n)
            for c in [*filters, 2 * filters[-1] if j == 0 else wide])
        self.head = nn.Conv2d(wide, out_channels, 1)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, x, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        n = self.depth
        h = x.permute(0, 3, 1, 2)
        enc = []
        for block in self.blocks[:n]:
            h = block(h)
            enc.append(h)
            h = F.avg_pool2d(h, 2)
        dec = self.blocks[n](h)
        for j, level in enumerate(reversed(range(n))):
            hw = enc[level].shape[2:]
            convs = self.convs[j * (n + 1):(j + 1) * (n + 1)]
            feats = [conv(resize_to(src, hw))
                     for conv, src in zip(convs, [*enc, dec])]
            dec = self.blocks[n + 1 + j](torch.cat(feats, dim=1))
        return _head(dec, self.head, self.out_shape)


class MultiScaleUNet(nn.Module):
    """U-Net fed the input at every depth: before each encoder stage after
    the first, the input, halved again (floor; :func:`resize_to`,
    antialiased), goes through a SAME 3x3 conv to 4 channels
    (``convs[i - 1]``) and joins the pooled features; a ConvBlock bottom
    at ``2 * filters[-1]`` and UpCat stages; sigmoid output."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 out_shape: tuple[int, int] | None = None,
                 norm: str = "group",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_shape = None if out_shape is None else tuple(out_shape)
        ins = [in_channels, *(f + 4 for f in filters[:-1])]
        self.blocks = nn.ModuleList(
            [ConvBlock(cin, f, norm) for cin, f in zip(ins, filters)]
            + [ConvBlock(filters[-1], 2 * filters[-1], norm)])
        self.convs = nn.ModuleList(nn.Conv2d(in_channels, 4, 3, padding=1)
                                   for _ in filters[1:])
        self.upcats = _decoder(filters, 2 * filters[-1], norm)
        self.head = nn.Conv2d(filters[0], out_channels, 1)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, x, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        h = scaled = x.permute(0, 3, 1, 2)
        skips = []
        for i, block in enumerate(self.blocks[:-1]):
            if i > 0:
                hh, ww = scaled.shape[2:]
                scaled = resize_to(scaled, (hh // 2, ww // 2))
                h = torch.cat([h, self.convs[i - 1](scaled)], dim=1)
            h = block(h)
            skips.append(h)
            h = F.avg_pool2d(h, 2)
        h = self.blocks[-1](h)
        for up, skip in zip(self.upcats, reversed(skips)):
            h = up(h, skip)
        return _head(h, self.head, self.out_shape)


class RecurrentConvBlock(nn.Module):
    """Recurrent conv unit: one SAME 3x3 conv and one GroupNorm shared by
    ``t + 1`` passes, h = LeakyReLU(gn(conv(x))) then h = LeakyReLU(gn(conv(x
    + h))) ``t`` times; a 1x1 conv first maps the input to ``features``
    where its channels differ (``convs`` is then [1x1, 3x3], else
    [3x3])."""

    def __init__(self, in_channels: int, features: int, t: int = 2):
        super().__init__()
        self.t = t
        self.convs = nn.ModuleList(
            ([nn.Conv2d(in_channels, features, 1)]
             if in_channels != features else [])
            + [nn.Conv2d(features, features, 3, padding=1)])
        self.norms = nn.ModuleList([group_norm(features)])

    def forward(self, x):
        if len(self.convs) == 2:
            x = self.convs[0](x)
        conv, gn = self.convs[-1], self.norms[0]
        h = F.leaky_relu(gn(conv(x)), LEAKY_SLOPE)
        for _ in range(self.t):
            h = F.leaky_relu(gn(conv(x + h)), LEAKY_SLOPE)
        return h


class R2UNet(nn.Module):
    """Recurrent-residual U-Net: each encoder stage is a 1x1 conv
    (``convs[i]``) then its output plus a :class:`RecurrentConvBlock` of
    it; a RecurrentConvBlock bottom at ``2 * filters[-1]``; UpCat stages,
    each skip through :class:`CBAM` first with ``use_attention`` (the
    R2AttU name); sigmoid output."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 out_shape: tuple[int, int] | None = None, t: int = 2,
                 use_attention: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_shape = None if out_shape is None else tuple(out_shape)
        chans = [in_channels, *filters]
        self.convs = nn.ModuleList(nn.Conv2d(cin, f, 1)
                                   for cin, f in zip(chans, filters))
        self.recs = nn.ModuleList(
            [RecurrentConvBlock(f, f, t) for f in filters]
            + [RecurrentConvBlock(filters[-1], 2 * filters[-1], t)])
        self.cbams = (nn.ModuleList(CBAM(f) for f in reversed(filters))
                      if use_attention else None)
        self.upcats = _decoder(filters, 2 * filters[-1])
        self.head = nn.Conv2d(filters[0], out_channels, 1)
        if generator is not None:
            init_flax_like(self, generator)

    def forward(self, x, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        x = x.permute(0, 3, 1, 2)
        skips = []
        for conv, rec in zip(self.convs, self.recs):
            sc = conv(x)
            x = sc + rec(sc)
            skips.append(x)
            x = F.avg_pool2d(x, 2)
        x = self.recs[-1](x)
        for i, (up, skip) in enumerate(zip(self.upcats, reversed(skips))):
            if self.cbams is not None:
                skip = self.cbams[i](skip)
            x = up(x, skip)
        return _head(x, self.head, self.out_shape)
