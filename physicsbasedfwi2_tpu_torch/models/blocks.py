"""Building blocks of the generator (port of
``physicsbasedfwi2_tpu/models/blocks.py``: the conv blocks, the U-Net
decoder stage ``UpCat`` with ``match_spatial`` and ``fit_to_shape``, CBAM
attention, squeeze-excite, ASPP and the residual conv block; and
:func:`resize_to`, ``jax.image.resize``'s bilinear to any size).

The modules here work in NCHW, PyTorch's layout; the nets in
:mod:`autoencoders`, :mod:`unets` and :mod:`vae` take and return NHWC at
their public interface, as the Flax nets do.  Matching Flax: GroupNorm
and LayerNorm eps 1e-6 (LayerNorm over the channels alone), LeakyReLU
slope 0.1, SAME convolutions, floor 2x2 average pooling, bilinear
upsampling with half-pixel centres, lecun-normal (truncated normal,
fan-in) kernels with zero biases from an explicit generator, and
``nn.Dropout``'s semantics (keep with probability 1 - rate, kept values
scaled by 1 / (1 - rate)) with the mask drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

NORM_EPS = 1e-6  # flax.linen.GroupNorm's and LayerNorm's default
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


def same_padding(size: int, kernel: int, stride: int = 1,
                 dilation: int = 1) -> tuple[int, int]:
    """Flax's ``padding="SAME"`` on one axis of length ``size``: (before,
    after) with total max((ceil(size / stride) - 1) stride + (kernel - 1)
    dilation + 1 - size, 0), the odd one after.  Asymmetric for a stride-2
    3x3 conv on an even size (0, 1) and for a 4x4 conv at stride 1 (1, 2)
    or at stride 2 on an odd size (1, 2)."""
    span = (kernel - 1) * dilation + 1
    total = max((-(-size // stride) - 1) * stride + span - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with Flax's ``padding="SAME"`` for any kernel size and
    stride: the input is zero-padded by :func:`same_padding` (``F.pad``)
    on each axis, then convolved unpadded."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, dilation=dilation)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        (dh, dw) = self.dilation
        top, bottom = same_padding(x.shape[2], kh, sh, dh)
        left, right = same_padding(x.shape[3], kw, sw, dw)
        return super().forward(F.pad(x, (left, right, top, bottom)))


def same_conv(in_channels: int, out_channels: int, kernel_size: int,
              stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    """A conv with Flax's ``padding="SAME"``: ``nn.Conv2d`` with symmetric
    padding where SAME is symmetric on every size (odd kernel, stride 1),
    else :class:`SameConv2d`."""
    if stride == 1 and kernel_size % 2 == 1:
        return nn.Conv2d(in_channels, out_channels, kernel_size,
                         padding=dilation * (kernel_size // 2),
                         dilation=dilation)
    return SameConv2d(in_channels, out_channels, kernel_size, stride,
                      dilation)


def group_norm(channels: int, groups: int | None = None) -> nn.GroupNorm:
    """Flax's ``nn.GroupNorm`` (eps 1e-6) over ``channels``: ``groups``
    groups, or :func:`num_groups_for` of them."""
    return nn.GroupNorm(groups or num_groups_for(channels), channels,
                        eps=NORM_EPS)


class ChannelLayerNorm(nn.Module):
    """Flax's ``nn.LayerNorm()`` on an NHWC tensor, applied to NCHW:
    each pixel normalized over its channels (dim 1) with eps 1e-6, then
    a per-channel scale (``weight``) and ``bias``.  (``nn.LayerNorm(C)``
    on NCHW would normalize over the last axis, the width.)"""

    def __init__(self, features: int, eps: float = NORM_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        y = F.layer_norm(x.permute(0, 2, 3, 1), self.weight.shape,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 3, 1, 2)


def _norm(norm: str, features: int) -> nn.Module:
    if norm == "group":
        return group_norm(features)
    if norm == "layer":
        return ChannelLayerNorm(features)
    if norm == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {norm!r}")


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


def _resize_2x_transpose(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The transpose of the 2x half-pixel bilinear upsample along ``dim``
    with clamped edges: input i gets 0.75 (g[2i] + g[2i+1]) + 0.25
    (g[2i-1] + g[2i+2]), the edge rows the clamped 0.25 terms (g[-1] is
    g[0], g[2n] is g[2n-1]).  Slices and adds, no atomics."""
    pairs = g.unflatten(dim, (-1, 2))
    ge, go = pairs.select(dim + 1, 0), pairs.select(dim + 1, 1)
    n = ge.shape[dim]
    prev = torch.cat([ge.narrow(dim, 0, 1), go.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([ge.narrow(dim, 1, n - 1), go.narrow(dim, n - 1, 1)], dim)
    return 0.75 * (ge + go) + 0.25 * (prev + nxt)


class _Resize2x(torch.autograd.Function):
    """``F.interpolate(scale_factor=2, bilinear)`` forward; its backward
    is the fixed transpose (:func:`_resize_2x_transpose` on each axis),
    which repeats bit for bit where the CUDA backward's atomic adds do
    not."""

    @staticmethod
    def forward(ctx, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):
        return _resize_2x_transpose(_resize_2x_transpose(g, 2), 3)


def resize_2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of NCHW (``jax.image.resize`` bilinear:
    half-pixel centres, edge samples clamped), with a deterministic
    backward."""
    return _Resize2x.apply(x)


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


def match_spatial(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Center pad (with zeros) or crop NCHW ``x`` to (h, w), each axis on
    its own.  A 2x-upsampled decoder tensor meets its encoder skip here:
    with odd sizes the pooled-then-doubled size lands on either side of
    the skip's (nt 4001: 4000 against the skip's 4001, padded)."""
    dh, dw = h - x.shape[2], w - x.shape[3]
    if dh > 0 or dw > 0:
        ph, pw = max(dh, 0), max(dw, 0)
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    if dh < 0 or dw < 0:
        oh, ow = max(-dh, 0) // 2, max(-dw, 0) // 2
        x = x[:, :, oh:oh + h, ow:ow + w]
    return x


def upsample_weights(n_in: int, n_out: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """The [n_out, n_in] matrix of ``F.interpolate(size=..., bilinear,
    align_corners=False)`` along one axis with ``n_out >= n_in``: source
    position max(0, (j + 0.5) n_in / n_out - 0.5), its two neighbours
    (the upper clamped to n_in - 1) weighted by distance."""
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out)
           - 0.5).clamp(min=0.0)
    i0 = src.floor().long().clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    lam = src - i0
    w = torch.zeros(n_out, n_in, dtype=torch.float64)
    rows = torch.arange(n_out)
    w.index_put_((rows, i0), 1.0 - lam, accumulate=True)
    w.index_put_((rows, i1), lam, accumulate=True)
    return w.to(dtype=dtype, device=device)


class _ResizeTo(torch.autograd.Function):
    """``F.interpolate(size=size, bilinear)`` forward (an enlargement or
    identity on each axis); backward Wzᵀ · g · Wx with the separable
    weight matrices of :func:`upsample_weights` (matmuls in float64, no
    atomics)."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.in_hw = tuple(x.shape[2:])
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):
        (h, w), (nz, nx) = ctx.in_hw, g.shape[2:]
        gx = g.double()
        if nz != h:
            gx = upsample_weights(h, nz, gx.dtype, g.device).T @ gx
        if nx != w:
            gx = gx @ upsample_weights(w, nx, gx.dtype, g.device)
        return gx.to(g.dtype), None


def fit_to_shape(x: torch.Tensor, out_shape) -> torch.Tensor:
    """Map NCHW decoder output to the model grid ``out_shape`` (nz, nx):
    bilinear-upscale any axis that is too small (few-receiver inputs),
    then crop from the top-left.  The resize only ever enlarges or keeps
    an axis, where ``F.interpolate(..., align_corners=False)`` is
    ``jax.image.resize``'s bilinear; JAX antialiases when it shrinks an
    axis, which this function never asks of it.  Its backward is
    deterministic (:class:`_ResizeTo`)."""
    h, w = x.shape[2], x.shape[3]
    nz, nx = out_shape
    if h < nz or w < nx:
        x = _ResizeTo.apply(x, (max(h, nz), max(w, nx)))
    return x[:, :, :nz, :nx]


@functools.lru_cache(maxsize=64)
def _shrink_weights(n_in: int, n_out: int,
                    device: torch.device) -> torch.Tensor:
    """``data/prep.py::resize_weights(n_in, n_out)`` ([n_in, n_out],
    float32) on ``device``, cached."""
    from physicsbasedfwi2_tpu_torch.data.prep import resize_weights
    return torch.from_numpy(resize_weights(n_in, n_out)).to(device)


def resize_to(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, size, "bilinear")`` of NCHW ``x`` to ``size``
    (h, w), each axis on its own: an axis that shrinks is a matmul with
    JAX's antialiased triangle-kernel weights (:func:`_shrink_weights`),
    whose backward is the transposed matmul; an axis that grows goes
    through :class:`_ResizeTo`; an axis that keeps its size is left as it
    is.  No atomics either way, so the backward repeats bit for bit."""
    (h, w), (nz, nx) = x.shape[2:], tuple(size)
    if nx < w:
        x = x @ _shrink_weights(w, nx, x.device)
    if nz < h:
        x = (x.transpose(2, 3) @ _shrink_weights(h, nz, x.device)
             ).transpose(2, 3)
    if nz > h or nx > w:
        x = _ResizeTo.apply(x, (nz, nx))
    return x


class UpCat(nn.Module):
    """U-Net decoder stage: bilinear 2x upsample, a SAME 3x3 conv to
    ``features``, :func:`match_spatial` to the skip, concatenation
    [skip, x] along the channels, and a ConvBlock."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 norm: str = "group"):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, 3, padding=1)
        self.block = ConvBlock(skip_channels + features, features, norm)

    def forward(self, x, skip):
        x = self.conv(resize_2x(x))
        x = match_spatial(x, skip.shape[2], skip.shape[3])
        return self.block(torch.cat([skip, x], dim=1))


CBAM_REDUCTION = 16  # the channel gate's MLP narrows channels by this


class ChannelGate(nn.Module):
    """CBAM channel attention: one MLP (channels -> channels //
    CBAM_REDUCTION, at least 1 -> channels) shared by the spatial mean and
    the spatial max; the sigmoid of their sum scales each channel."""

    def __init__(self, channels: int):
        super().__init__()
        hidden = max(channels // CBAM_REDUCTION, 1)
        self.mlp = nn.Sequential(nn.Linear(channels, hidden), nn.ReLU(),
                                 nn.Linear(hidden, channels))

    def forward(self, x):
        gate = torch.sigmoid(self.mlp(x.mean(dim=(2, 3)))
                             + self.mlp(x.amax(dim=(2, 3))))
        return x * gate[:, :, None, None]


class SpatialGate(nn.Module):
    """CBAM spatial attention: a SAME 7x7 conv over the channel max and
    mean; its sigmoid scales each pixel."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, 7, padding=3)

    def forward(self, x):
        pooled = torch.cat([x.amax(dim=1, keepdim=True),
                            x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.conv(pooled))


class CBAM(nn.Module):
    """Convolutional block attention: the channel gate, then the spatial
    gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.channel = ChannelGate(channels)
        self.spatial = SpatialGate()

    def forward(self, x):
        return self.spatial(self.channel(x))


class SqueezeExcite(nn.Module):
    """Squeeze-excite: an MLP (channels -> channels // ``reduction``, at
    least 1, ReLU, -> channels) of the spatial mean; its sigmoid scales
    each channel."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.mlp = nn.Sequential(nn.Linear(channels, hidden), nn.ReLU(),
                                 nn.Linear(hidden, channels))

    def forward(self, x):
        return x * torch.sigmoid(self.mlp(x.mean(dim=(2, 3))))[:, :, None,
                                                                 None]


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: one SAME 3x3 conv at each dilation
    ``rates`` with GroupNorm and ReLU, the branches concatenated and mapped
    to ``features`` by a 1x1 conv (``convs[-1]``)."""

    def __init__(self, in_channels: int, features: int,
                 rates=(1, 6, 12, 18)):
        super().__init__()
        self.convs = nn.ModuleList(
            [same_conv(in_channels, features, 3, dilation=r) for r in rates]
            + [nn.Conv2d(len(rates) * features, features, 1)])
        self.norms = nn.ModuleList(group_norm(features) for _ in rates)

    def forward(self, x):
        branches = [F.relu(norm(conv(x)))
                    for conv, norm in zip(self.convs, self.norms)]
        return self.convs[-1](torch.cat(branches, dim=1))


class ResidualConv(nn.Module):
    """Pre-activation residual block: GroupNorm, ReLU, SAME 3x3 conv at
    ``stride``, GroupNorm, ReLU, SAME 3x3 conv; plus a 1x1 conv at
    ``stride`` of the input (``convs[2]``)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.norms = nn.ModuleList([group_norm(in_channels),
                                    group_norm(features)])
        self.convs = nn.ModuleList([
            same_conv(in_channels, features, 3, stride),
            same_conv(features, features, 3),
            same_conv(in_channels, features, 1, stride)])

    def forward(self, x):
        h = self.convs[0](F.relu(self.norms[0](x)))
        h = self.convs[1](F.relu(self.norms[1](h)))
        return h + self.convs[2](x)


def scale_to_range(x01: torch.Tensor, vmin, vmax) -> torch.Tensor:
    """Map sigmoid output [0,1] to [vmin, vmax]."""
    return vmin + x01 * (vmax - vmin)


def pin_water(model: torch.Tensor, true_model: torch.Tensor,
              water_vel: float = 1500.0) -> torch.Tensor:
    """Pin water cells to the known water velocity."""
    return torch.where(true_model == water_vel,
                       torch.full_like(model, water_vel), model)
