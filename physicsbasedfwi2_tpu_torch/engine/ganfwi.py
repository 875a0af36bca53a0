"""GAN-prior FWI (port of ``physicsbasedfwi2_tpu/engine/ganfwi.py``).

A pretrained generator G(z) -> velocity composes with the differentiable
propagator (:func:`simulate_acoustic`, plain autograd); SGLD or SGHMC
(:mod:`optim.sgmcmc`) sample the posterior over the latent z under the
physics misfit, a well-log misfit and a standard-normal prior.
"""

from __future__ import annotations

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.ops import (
    l1_misfit, l2_misfit, simulate_acoustic, trace_normalize,
)
from physicsbasedfwi2_tpu_torch.optim.sgmcmc import sghmc, sgld


def well_loss(model, well_model, well_cols, *, kind: str = "l2"):
    """Borehole-sample misfit: the model's columns ``well_cols`` against
    ``well_model``'s."""
    mis = l1_misfit if kind == "l1" else l2_misfit
    return mis(model[:, well_cols], well_model[:, well_cols])


def prior_loss(z):
    """Standard-normal latent prior: 0.5 |z|^2."""
    return 0.5 * torch.sum(z ** 2)


class GanFWI:
    """Posterior sampling over a frozen generator's latent with physics,
    well and prior losses.  ``decode_fn``: z [1, z_dim] -> vp [nz, nx].
    z starts at zeros on the workload's device, where the sampler's noise
    generator (seeded ``seed``) lives too."""

    def __init__(self, decode_fn, z_dim: int, workload, *,
                 sampler: str = "sgld", lr: float = 1e-3,
                 lambda_well: float = 0.0, lambda_prior: float = 1e-3,
                 well_cols=None, seed: int = 0):
        self.wl = workload
        self.decode = decode_fn
        self.lambda_well = lambda_well
        self.lambda_prior = lambda_prior
        self.well_cols = (None if well_cols is None else
                          torch.as_tensor(well_cols, device=workload.device))
        self.z = torch.zeros((1, z_dim), device=workload.device,
                             requires_grad=True)
        make = sgld if sampler == "sgld" else sghmc
        self.opt = make([self.z], lr, seed=seed)
        self._geom = workload.geom

    def _loss(self):
        """(loss, vp) at the current z."""
        wl = self.wl
        vp = self.decode(self.z)
        pred = simulate_acoustic(vp, wl.wavelet, *self._geom, wl.cfg)
        loss = torch.mean((trace_normalize(pred) - wl.obs_norm) ** 2)
        if self.lambda_well > 0 and self.well_cols is not None:
            loss = loss + self.lambda_well * well_loss(vp, wl.vp_true,
                                                       self.well_cols)
        return loss + self.lambda_prior * prior_loss(self.z), vp

    def sample(self, n_steps: int, *, burn_in: int = 0, thin: int = 1):
        """Run the chain for ``n_steps``; returns (each step's loss at its
        starting z, the models of the steps from ``burn_in`` on, every
        ``thin``-th, as numpy [k, nz, nx])."""
        losses, samples = [], []
        for i in range(n_steps):
            self.opt.zero_grad(set_to_none=True)
            loss, vp = self._loss()
            loss.backward()
            self.opt.step()
            losses.append(loss.detach())
            if i >= burn_in and (i - burn_in) % thin == 0:
                samples.append(vp.detach())
        return (torch.stack(losses).tolist(),
                np.stack([s.cpu().numpy() for s in samples]))
