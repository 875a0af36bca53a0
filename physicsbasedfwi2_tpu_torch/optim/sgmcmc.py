"""Stochastic-gradient MCMC samplers (port of
``physicsbasedfwi2_tpu/optim/sgmcmc.py``): SGLD and SGHMC as
``torch.optim.Optimizer`` subclasses, for Bayesian posterior sampling
over a generator's weights.

Each optimizer draws its noise from a ``torch.Generator`` of its own on
the parameters' device, seeded from ``seed``: a new optimizer restarts
the stream, as optax's ``init`` resets its key.  As optax updates every
leaf of the tree, a parameter without a gradient (``.grad`` None) is
updated as with a zero gradient: it still takes its noise and, under
SGHMC, its momentum's decay.
"""

from __future__ import annotations

import math

import torch


class _SgMcmc(torch.optim.Optimizer):
    """The shared parts: param groups with ``lr`` and ``temperature``, the
    noise generator, and each parameter's gradient with None as zeros."""

    def __init__(self, params, defaults: dict, seed: int):
        super().__init__(params, defaults)
        device = self.param_groups[0]["params"][0].device
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def _noise(self, p: torch.Tensor) -> torch.Tensor:
        return torch.randn(p.shape, generator=self.generator,
                           dtype=p.dtype, device=p.device)

    @staticmethod
    def _grad(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p) if p.grad is None else p.grad


class SGLD(_SgMcmc):
    """Stochastic gradient Langevin dynamics:
    p <- p - lr g + N(0, 2 lr T) per element."""

    def __init__(self, params, lr: float, *, seed: int = 0,
                 temperature: float = 1.0):
        super().__init__(params, {"lr": lr, "temperature": temperature},
                         seed)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr = group["lr"]
            scale = math.sqrt(2.0 * lr * group["temperature"])
            for p in group["params"]:
                p.add_(-lr * self._grad(p) + scale * self._noise(p))
        return loss


class SGHMC(_SgMcmc):
    """Stochastic gradient Hamiltonian Monte Carlo with friction ``a``:
    v <- (1 - a) v - lr g + N(0, 2 a lr T), then p <- p + v; v starts at
    zero."""

    def __init__(self, params, lr: float, *, friction: float = 0.05,
                 seed: int = 0, temperature: float = 1.0):
        super().__init__(params, {"lr": lr, "friction": friction,
                                  "temperature": temperature}, seed)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, a = group["lr"], group["friction"]
            scale = math.sqrt(2.0 * a * lr * group["temperature"])
            for p in group["params"]:
                state = self.state[p]
                if "momentum" not in state:
                    state["momentum"] = torch.zeros_like(p)
                v = ((1.0 - a) * state["momentum"] - lr * self._grad(p)
                     + scale * self._noise(p))
                state["momentum"] = v
                p.add_(v)
        return loss


# the JAX package's names (optax's sgld(learning_rate, seed=,
# temperature=) and sghmc(learning_rate, friction=, seed=, temperature=)),
# which take the parameters first here, as torch.optim does
sgld = SGLD
sghmc = SGHMC
