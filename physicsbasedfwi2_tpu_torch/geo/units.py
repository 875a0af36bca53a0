"""Unit conventions at the data boundary (port of
``physicsbasedfwi2_tpu/geo/units.py``).

The reference stores elastic models divided by 100 ("hectometre"
units) and multiplies by 10 with a flipud before handing them to
DENISE.  Both quirks are one documented, invertible transform here, so
stored datasets from the reference stay loadable while everything
inside the package is SI (m/s, kg/m^3) with row 0 = surface.
"""

from __future__ import annotations

import torch

STORAGE_SCALE = 100.0


def model_from_storage(m, *, scale: float = STORAGE_SCALE,
                       flip: bool = False) -> torch.Tensor:
    """Storage units -> SI. ``flip`` undoes a bottom-up row order
    (reverses dim -2)."""
    m = torch.as_tensor(m) * scale
    if flip:
        m = torch.flip(m, (-2,))
    return m


def model_to_storage(m, *, scale: float = STORAGE_SCALE,
                     flip: bool = False) -> torch.Tensor:
    """SI -> storage units (inverse of :func:`model_from_storage`)."""
    m = torch.as_tensor(m) / scale
    if flip:
        m = torch.flip(m, (-2,))
    return m
