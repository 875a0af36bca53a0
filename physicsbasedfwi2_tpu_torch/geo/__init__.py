"""Grids, wavelets, acquisition geometry, filters and unit
conventions."""

from physicsbasedfwi2_tpu_torch.geo.grid import Grid2D, cfl_dt, check_cfl
from physicsbasedfwi2_tpu_torch.geo.wavelets import ricker, spike_band
from physicsbasedfwi2_tpu_torch.geo.acquisition import (
    Acquisition,
    elastic_line,
    marmousi_acoustic_acquisition,
    marmousi_elastic_acquisition,
    seabed_rows,
    seam_elastic_acquisition,
    surface_line,
)
from physicsbasedfwi2_tpu_torch.geo.filters import (
    butter_lowpass_coeffs,
    lowpass_filter_time,
)
from physicsbasedfwi2_tpu_torch.geo.units import (
    STORAGE_SCALE,
    model_from_storage,
    model_to_storage,
)

__all__ = [
    "Grid2D",
    "cfl_dt",
    "check_cfl",
    "ricker",
    "spike_band",
    "Acquisition",
    "elastic_line",
    "seabed_rows",
    "surface_line",
    "marmousi_acoustic_acquisition",
    "marmousi_elastic_acquisition",
    "seam_elastic_acquisition",
    "butter_lowpass_coeffs",
    "lowpass_filter_time",
    "STORAGE_SCALE",
    "model_from_storage",
    "model_to_storage",
]
