"""Normalizing flows over a flat latent (port of
``physicsbasedfwi2_tpu/models/flows.py``): the GLOW-style affine
couplings of the AutoNF generator (:class:`LatentFlow`) and the planar
flows of the VaeNormalizing generators (:class:`PlanarFlowStack`).

Each flow maps z [B, D] to (z', log|det dz'/dz| [B]).
"""

from __future__ import annotations

import torch
from torch import nn

COUPLING_HIDDEN = 64     # width of each affine coupling's MLP
COUPLING_CLAMP = 2.0     # the log-scale is soft-clamped to +-this
LATENT_FLOW_BLOCKS = 4   # affine couplings in a LatentFlow
PLANAR_FLOWS = 8         # planar flows in a PlanarFlowStack


class AffineCoupling(nn.Module):
    """GLOW-style affine coupling on a latent of size ``dim``: one half
    (``za``) predicts a soft-clamped log-scale and a shift of the other
    (``zb``); ``swap`` exchanges the halves' roles.  The MLP is
    ``dim // 2`` (or the rest) -> COUPLING_HIDDEN -> COUPLING_HIDDEN ->
    2 * |zb|, with ReLU between."""

    def __init__(self, dim: int, swap: bool = False):
        super().__init__()
        d = dim // 2
        n_a, n_b = (dim - d, d) if swap else (d, dim - d)
        self.swap = swap
        h = COUPLING_HIDDEN
        self.mlp = nn.Sequential(
            nn.Linear(n_a, h), nn.ReLU(), nn.Linear(h, h), nn.ReLU(),
            nn.Linear(h, 2 * n_b))

    def forward(self, z, *, reverse: bool = False):
        d = z.shape[-1] // 2
        za, zb = ((z[..., d:], z[..., :d]) if self.swap
                  else (z[..., :d], z[..., d:]))
        s_raw, t = self.mlp(za).chunk(2, dim=-1)
        log_s = COUPLING_CLAMP * torch.tanh(s_raw / COUPLING_CLAMP)
        if reverse:
            zb = (zb - t) * torch.exp(-log_s)
            logdet = -torch.sum(log_s, dim=-1)
        else:
            zb = zb * torch.exp(log_s) + t
            logdet = torch.sum(log_s, dim=-1)
        out = torch.cat([zb, za] if self.swap else [za, zb], dim=-1)
        return out, logdet


class LatentFlow(nn.Module):
    """``LATENT_FLOW_BLOCKS`` affine couplings, alternating which half
    conditions the other; ``reverse=True`` inverts the stack (the blocks in
    reverse order, each inverted) and returns the inverse's
    log-determinant."""

    def __init__(self, dim: int):
        super().__init__()
        self.couplings = nn.ModuleList(
            AffineCoupling(dim, swap=bool(i % 2))
            for i in range(LATENT_FLOW_BLOCKS))

    def forward(self, z, *, reverse: bool = False):
        total = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        blocks = reversed(self.couplings) if reverse else self.couplings
        for blk in blocks:
            z, ld = blk(z, reverse=reverse)
            total = total + ld
        return z, total


class PlanarFlow(nn.Module):
    """Planar flow z' = z + u_hat tanh(w.z + b), with u_hat the
    projection of ``u`` that keeps w.u_hat >= -1 (invertible).  ``u`` and
    ``w`` start N(0, 0.1^2) from ``generator`` and ``b`` at 0, as Flax
    initializes them."""

    def __init__(self, dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.u = nn.Parameter(0.1 * torch.randn(dim, generator=generator))
        self.w = nn.Parameter(0.1 * torch.randn(dim, generator=generator))
        self.b = nn.Parameter(torch.zeros(()))

    def forward(self, z):
        u, w = self.u, self.w
        wu = torch.dot(w, u)
        m = -1 + torch.log1p(torch.exp(wu))
        u_hat = u + (m - wu) * w / (torch.dot(w, w) + 1e-12)
        lin = z @ w + self.b
        f = z + u_hat * torch.tanh(lin)[..., None]
        psi = (1 - torch.tanh(lin) ** 2)[..., None] * w
        logdet = torch.log(torch.abs(1 + psi @ u_hat) + 1e-12)
        return f, logdet


class PlanarFlowStack(nn.Module):
    """``PLANAR_FLOWS`` planar flows (attributes ``flow0``, ``flow1``,
    ..., the Flax submodule names); returns (z_K, the summed log-det)."""

    def __init__(self, dim: int, generator: torch.Generator | None = None):
        super().__init__()
        for i in range(PLANAR_FLOWS):
            setattr(self, f"flow{i}", PlanarFlow(dim, generator))

    def forward(self, z):
        total = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for i in range(PLANAR_FLOWS):
            z, ld = getattr(self, f"flow{i}")(z)
            total = total + ld
        return z, total
