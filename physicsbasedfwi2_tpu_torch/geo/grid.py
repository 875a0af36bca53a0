"""Regular 2D grids and CFL stability helpers.

The reference hard-codes grid shapes inside each net's ``prop()``
(e.g. the reference's models/networks.py:5339-5345: 151x200 cells,
dx=10 m, nt=4001, dt=1 ms).  Here the grid is an explicit, hashable
static configuration object.  Pure Python: a copy of
``physicsbasedfwi2_tpu/geo/grid.py``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """Static description of a 2D finite-difference grid.

    Attributes:
        nz: number of cells in depth (rows, axis 0).
        nx: number of cells laterally (cols, axis 1).
        dx: cell size in metres (isotropic).
        nt: number of time steps.
        dt: time step in seconds.
        pml_width: PML absorbing-layer thickness in cells on each
            absorbing side.
        free_surface: if True the top edge is a free surface (no PML
            there); otherwise all four sides absorb.
    """

    nz: int
    nx: int
    dx: float
    nt: int
    dt: float
    pml_width: int = 20
    free_surface: bool = False

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nz, self.nx)

    @property
    def padded_shape(self) -> tuple[int, int]:
        """Interior + PML halo shape."""
        w = self.pml_width
        nz = self.nz + w * (1 if self.free_surface else 2)
        return (nz, self.nx + 2 * w)

    @property
    def top_pad(self) -> int:
        return 0 if self.free_surface else self.pml_width

    @property
    def duration(self) -> float:
        return self.nt * self.dt


# Max |stencil coefficient| sums for staggered-grid first-derivative
# operators of order 2/4/8 (Taylor coefficients).
_STENCIL_SUM = {2: 1.0, 4: 9.0 / 8.0 + 1.0 / 24.0, 8: 1.2627}


def cfl_dt(vmax: float, dx: float, order: int = 4, ndim: int = 2) -> float:
    """Largest stable dt for a staggered-grid leapfrog scheme.

    Mirrors the role of devito's ``critical_dt``
    (the reference's seisgan/fwi/pde/seismic/model.py:162) but for our
    staggered-grid formulation: dt <= dx / (vmax * sqrt(ndim) * S)
    where S is the sum of |coefficients| of the spatial operator.
    """
    s = _STENCIL_SUM[order]
    return dx / (vmax * math.sqrt(ndim) * s)


def check_cfl(vmax: float, grid: Grid2D, order: int = 4) -> None:
    """Raise if the configured dt violates the CFL bound."""
    limit = cfl_dt(vmax, grid.dx, order=order)
    if grid.dt > limit:
        raise ValueError(
            f"dt={grid.dt} unstable for vmax={vmax}, dx={grid.dx} "
            f"(CFL limit {limit:.6g}s at order {order})"
        )
