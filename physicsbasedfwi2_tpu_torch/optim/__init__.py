"""Optimizers and learning-rate schedules."""

from physicsbasedfwi2_tpu_torch.optim.schedules import make_scheduler

__all__ = ["make_scheduler"]
