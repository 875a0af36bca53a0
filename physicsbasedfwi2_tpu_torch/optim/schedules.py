"""Learning-rate schedules (port of
``physicsbasedfwi2_tpu/optim/schedules.py``): linear / step / cosine
as epoch -> lr callables, plateau as a small host-side controller
(torch's ReduceLROnPlateau role)."""

from __future__ import annotations

import dataclasses
import math


def make_scheduler(policy: str, *, lr: float, n_epochs: int = 100,
                   n_epochs_decay: int = 100, lr_decay_iters: int = 50,
                   step_gamma: float = 0.1):
    """Return a callable epoch -> lr, or a PlateauController for
    policy='plateau'."""
    if policy == "linear":
        # constant for n_epochs then linear to 0 over n_epochs_decay
        def sched(epoch):
            frac = min(max((epoch - n_epochs) / max(n_epochs_decay, 1),
                           0.0), 1.0)
            return lr * (1.0 - frac)
        return sched
    if policy == "step":
        # optax.exponential_decay(staircase=True)
        return lambda epoch: lr * step_gamma ** (epoch // lr_decay_iters)
    if policy == "cosine":
        # optax.cosine_decay_schedule(decay_steps=n_epochs, alpha=0)
        return lambda epoch: lr * 0.5 * (
            1.0 + math.cos(math.pi * min(epoch, n_epochs) / n_epochs))
    if policy == "plateau":
        return PlateauController(lr=lr)
    raise ValueError(f"unknown lr policy {policy!r}")


@dataclasses.dataclass
class PlateauController:
    """ReduceLROnPlateau equivalent, stepped once per epoch with a
    metric."""

    lr: float
    factor: float = 0.2
    patience: int = 5
    threshold: float = 0.01
    min_lr: float = 1e-8

    best: float = float("inf")
    bad_epochs: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
