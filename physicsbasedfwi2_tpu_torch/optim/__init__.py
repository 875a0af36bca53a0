"""Optimizers and learning-rate schedules."""

from physicsbasedfwi2_tpu_torch.optim.lbfgs import LbfgsState, lbfgs_wolfe
from physicsbasedfwi2_tpu_torch.optim.schedules import make_scheduler

__all__ = ["make_scheduler", "lbfgs_wolfe", "LbfgsState"]
