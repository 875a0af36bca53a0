"""Grids, wavelets and acquisition geometry."""

from physicsbasedfwi2_tpu_torch.geo.grid import Grid2D, cfl_dt, check_cfl
from physicsbasedfwi2_tpu_torch.geo.wavelets import ricker
from physicsbasedfwi2_tpu_torch.geo.acquisition import (
    Acquisition,
    surface_line,
)

__all__ = [
    "Grid2D",
    "cfl_dt",
    "check_cfl",
    "ricker",
    "Acquisition",
    "surface_line",
]
