"""SSIM metric and loss (port of ``physicsbasedfwi2_tpu/ops/ssim.py``):
Gaussian-window structural similarity of NHWC batches, differentiable."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from physicsbasedfwi2_tpu_torch.models.blocks import same_padding


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    """The normalized [size, size] Gaussian, in float32."""
    x = torch.arange(size, dtype=torch.float32, device=device) - (
        size - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def _filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise SAME convolution of NCHW ``img`` by ``kernel`` [k, k]
    (one copy a channel, ``groups=C``)."""
    c = img.shape[1]
    k = kernel.shape[0]
    top, bottom = same_padding(img.shape[2], k)
    left, right = same_padding(img.shape[3], k)
    weight = kernel.to(img.dtype).expand(c, 1, k, k)
    return F.conv2d(F.pad(img, (left, right, top, bottom)), weight, groups=c)


def ssim(x: torch.Tensor, y: torch.Tensor, *, window_size: int = 11,
         sigma: float = 1.5, dynamic_range: float | None = None,
         reduce: bool = True) -> torch.Tensor:
    """Structural similarity of two NHWC batches (higher is better; a
    2-D input is one one-channel image).  ``dynamic_range`` defaults to the
    larger of the two inputs' max - min (+ 1e-12; the max and min split
    their gradient evenly among ties, as ``jnp.max`` does).  Returns the
    mean, or with ``reduce=False`` the NHWC map.  ``window_size=5`` is the
    reference's SSIM loss."""
    if x.ndim == 2:
        x = x[None, :, :, None]
        y = y[None, :, :, None]
    if dynamic_range is None:
        dynamic_range = torch.maximum(x.amax() - x.amin(),
                                      y.amax() - y.amin()) + 1e-12
    c1 = (0.01 * dynamic_range) ** 2
    c2 = (0.03 * dynamic_range) ** 2
    w = _gaussian_window(window_size, sigma, x.device)
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    mu_x = _filter2d(x, w)
    mu_y = _filter2d(y, w)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = _filter2d(x * x, w) - mu_x2
    sig_y = _filter2d(y * y, w) - mu_y2
    sig_xy = _filter2d(x * y, w) - mu_xy
    s = ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2))
    return torch.mean(s) if reduce else s.permute(0, 2, 3, 1)
