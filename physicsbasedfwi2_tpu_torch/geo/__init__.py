"""Grids, wavelets and acquisition geometry."""

from physicsbasedfwi2_tpu_torch.geo.grid import Grid2D, cfl_dt, check_cfl
from physicsbasedfwi2_tpu_torch.geo.wavelets import ricker
from physicsbasedfwi2_tpu_torch.geo.acquisition import (
    Acquisition,
    elastic_line,
    seabed_rows,
    surface_line,
)
from physicsbasedfwi2_tpu_torch.geo.filters import (
    butter_lowpass_coeffs,
    lowpass_filter_time,
)

__all__ = [
    "Grid2D",
    "cfl_dt",
    "check_cfl",
    "ricker",
    "Acquisition",
    "elastic_line",
    "seabed_rows",
    "surface_line",
    "butter_lowpass_coeffs",
    "lowpass_filter_time",
]
