"""The U-Net generator (port of ``physicsbasedfwi2_tpu/models/unets.py``:
``UNet``, the Unet22 and Att names of the registry).

The image-to-image variants of the supervised engine (``ASPPUNet``,
``ResUNetPlusPlus``, ``UNet3Plus``, ``MultiScaleUNet``, ``R2UNet``) are
not ported yet (ROADMAP Queue A, item 9).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from physicsbasedfwi2_tpu_torch.models.blocks import (
    CBAM, ConvBlock, UpCat, fit_to_shape, init_flax_like,
)


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
        rev = list(reversed(filters))
        ins = [2 * filters[-1], *rev[:-1]]
        self.upcats = nn.ModuleList(UpCat(cin, f, f, norm)
                                    for cin, f in zip(ins, rev))
        self.cbams = (nn.ModuleList(CBAM(f) for f in rev) if use_attention
                      else None)
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
