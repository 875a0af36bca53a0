"""Optimizers and learning-rate schedules."""

from physicsbasedfwi2_tpu_torch.optim.lbfgs import LbfgsState, lbfgs_wolfe
from physicsbasedfwi2_tpu_torch.optim.schedules import make_scheduler
from physicsbasedfwi2_tpu_torch.optim.sgmcmc import SGHMC, SGLD, sghmc, sgld

__all__ = ["make_scheduler", "lbfgs_wolfe", "LbfgsState", "sgld", "sghmc",
           "SGLD", "SGHMC"]
