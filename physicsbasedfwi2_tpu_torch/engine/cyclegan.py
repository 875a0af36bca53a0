"""CycleGAN engine (port of ``physicsbasedfwi2_tpu/engine/cyclegan.py``):
unpaired image translation between domains A and B.

Two resnet generators (G: A -> B, F: B -> A), two 2-layer PatchGAN
discriminators (DA on A, DB on B), adversarial + cycle-consistency +
identity losses, and image history pools for the discriminators.
"""

from __future__ import annotations

import itertools

import torch

from physicsbasedfwi2_tpu_torch.engine.engines import _resolve_device, _step
from physicsbasedfwi2_tpu_torch.device import default_device
from physicsbasedfwi2_tpu_torch.models import (
    ImagePool, NLayerDiscriminator, ResnetGenerator, gan_loss,
)


class CycleGanEngine:
    """The upstream CycleGAN recipe on NHWC images of ``channels``
    channels: G, F = :class:`ResnetGenerator` (``base``, ``n_blocks``), DA,
    DB = :class:`NLayerDiscriminator` (``base``, 2 layers), their weights
    from seeds ``seed`` .. ``seed + 3``, on ``device`` (default: the first
    CUDA card; raises when there is none).  A step trains G and F on
    the adversarial loss (``gan_mode``) of fake_B = G(a) under DB and
    fake_A = F(b) under DA, plus ``lambda_cycle`` times the L1 cycle
    losses |F(G(a)) - a| + |G(F(b)) - b| and ``lambda_cycle * lambda_idt``
    times the identity losses |G(b) - b| + |F(a) - a|; then DA and DB, on
    the real images against the fakes drawn through the two
    ``ImagePool(50)`` histories.  One Adam (``lr``, b1 ``beta1``) for the
    generators, one for the discriminators.  ``in_shape`` is taken for the
    JAX signature; no net sizes itself from it."""

    def __init__(self, *, channels: int = 1, base: int = 16,
                 n_blocks: int = 3, lr: float = 2e-4, beta1: float = 0.5,
                 lambda_cycle: float = 10.0, lambda_idt: float = 0.5,
                 gan_mode: str = "lsgan", in_shape=(64, 64), seed: int = 0,
                 device=None):
        self.lambda_cycle = lambda_cycle
        self.lambda_idt = lambda_idt
        self.gan_mode = gan_mode
        self.device = _resolve_device(device if device is not None
                                      else default_device())
        gens = [torch.Generator().manual_seed(seed + i) for i in range(4)]
        self.G, self.F = (ResnetGenerator(channels, channels, base, n_blocks,
                                          generator=g).to(self.device)
                          for g in gens[:2])
        self.DA, self.DB = (NLayerDiscriminator(channels, base, n_layers=2,
                                                generator=g).to(self.device)
                            for g in gens[2:])
        self.g_opt = torch.optim.Adam(
            itertools.chain(self.G.parameters(), self.F.parameters()), lr=lr,
            betas=(beta1, 0.999))
        self.d_opt = torch.optim.Adam(
            itertools.chain(self.DA.parameters(), self.DB.parameters()),
            lr=lr, betas=(beta1, 0.999))
        self.pool_A = ImagePool(50)
        self.pool_B = ImagePool(50)

    def optimize_parameters(self, a: torch.Tensor, b: torch.Tensor) -> dict:
        """One generator step, then one discriminator step.  Returns
        ``loss_G`` and ``loss_D``, each the loss before its step."""
        gm = self.gan_mode
        a, b = a.to(self.device), b.to(self.device)
        for d in (self.DA, self.DB):
            d.requires_grad_(False)
        fake_b, fake_a = self.G(a), self.F(b)
        adv = (gan_loss(self.DB(fake_b), True, gm)
               + gan_loss(self.DA(fake_a), True, gm))
        cyc = (torch.mean(torch.abs(self.F(fake_b) - a))
               + torch.mean(torch.abs(self.G(fake_a) - b))) * self.lambda_cycle
        idt = (torch.mean(torch.abs(self.G(b) - b))
               + torch.mean(torch.abs(self.F(a) - a))) * (
            self.lambda_cycle * self.lambda_idt)
        loss_g = adv + cyc + idt
        _step(self.g_opt, loss_g)
        for d in (self.DA, self.DB):
            d.requires_grad_(True)
        fa = self.pool_A.query(fake_a.detach())
        fb = self.pool_B.query(fake_b.detach())
        la = 0.5 * (gan_loss(self.DA(a), True, gm)
                    + gan_loss(self.DA(fa), False, gm))
        lb = 0.5 * (gan_loss(self.DB(b), True, gm)
                    + gan_loss(self.DB(fb), False, gm))
        loss_d = la + lb
        _step(self.d_opt, loss_d)
        gl, dl = torch.stack([loss_g.detach(), loss_d.detach()]).tolist()
        return {"loss_G": gl, "loss_D": dl}

    @torch.no_grad()
    def translate(self, a: torch.Tensor) -> torch.Tensor:
        """G(a): domain A to domain B."""
        return self.G(a.to(self.device))
