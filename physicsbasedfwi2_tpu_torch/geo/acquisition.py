"""Acquisition geometry as integer cell indices (numpy).

Port of ``physicsbasedfwi2_tpu/geo/acquisition.py``, copied as it is:
geometry stays host-side numpy and becomes int32 device tensors only
where a propagator reads it.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Acquisition:
    """Shot geometry on a grid.

    Attributes:
        src_z, src_x: [num_shots] int cell indices of the (single)
            source per shot.
        rcv_z, rcv_x: [num_shots, num_receivers] int cell indices.
    """

    src_z: np.ndarray
    src_x: np.ndarray
    rcv_z: np.ndarray
    rcv_x: np.ndarray

    @property
    def num_shots(self) -> int:
        return int(self.src_z.shape[0])

    @property
    def num_receivers(self) -> int:
        return int(self.rcv_z.shape[1])

    def __hash__(self):
        return hash((self.src_z.tobytes(), self.src_x.tobytes(),
                     self.rcv_z.tobytes(), self.rcv_x.tobytes()))

    def __eq__(self, other):
        return (isinstance(other, Acquisition)
                and np.array_equal(self.src_z, other.src_z)
                and np.array_equal(self.src_x, other.src_x)
                and np.array_equal(self.rcv_z, other.rcv_z)
                and np.array_equal(self.rcv_x, other.rcv_x))


def surface_line(num_shots: int, num_receivers: int, nx: int,
                 src_depth: int = 0, rcv_depth: int = 0) -> Acquisition:
    """Evenly spaced surface sources + a fixed surface receiver spread:
    sources at linspace(0, nx-1) over num_shots, receivers at
    arange(num_receivers) * nx/num_receivers, identical for all shots.
    """
    src_x = np.round(np.linspace(0, nx - 1, num_shots)).astype(np.int32)
    src_z = np.full(num_shots, src_depth, np.int32)
    rx = (np.arange(num_receivers) * (nx / num_receivers)).astype(np.int32)
    rcv_x = np.tile(rx, (num_shots, 1)).astype(np.int32)
    rcv_z = np.full_like(rcv_x, rcv_depth)
    return Acquisition(src_z, src_x, rcv_z, rcv_x)


def seabed_rows(model: np.ndarray, water_vel: float = 1500.0) -> np.ndarray:
    """Per-column first non-water row (the water-bottom index), for
    hanging receivers on the seabed.  Returns [nx] int32 row indices
    (0 where the column has no water)."""
    m = np.asarray(model)
    water = m == water_vel
    # deepest water row + 1 per column; columns with no water -> 0
    any_w = water.any(axis=0)
    deepest = np.where(any_w, water.shape[0] - 1 -
                       np.argmax(water[::-1], axis=0), -1)
    return (deepest + 1).astype(np.int32)


def elastic_line(num_shots: int, num_receivers: int, nx: int, nz: int,
                 *, src_row: int, rcv_row: int | None = None,
                 rcv_rows_per_col: np.ndarray | None = None,
                 src_x0: int = 2) -> Acquisition:
    """Elastic acquisition with explicit depth rows: evenly spaced
    sources at ``src_row``, a fixed receiver spread at ``rcv_row`` --
    or, when ``rcv_rows_per_col`` is given, per-receiver depths
    following the seabed."""
    src_x = np.round(np.linspace(src_x0, nx - 1 - src_x0,
                                 num_shots)).astype(np.int32)
    src_z = np.full(num_shots, min(src_row, nz - 2), np.int32)
    rx = np.round(np.linspace(1, nx - 2, num_receivers)).astype(np.int32)
    if rcv_rows_per_col is not None:
        rz_line = np.asarray(rcv_rows_per_col, np.int32)[rx]
        rz_line = np.clip(rz_line, 0, nz - 2)
    else:
        rz_line = np.full(num_receivers, min(rcv_row, nz - 2), np.int32)
    rcv_x = np.tile(rx, (num_shots, 1)).astype(np.int32)
    rcv_z = np.tile(rz_line, (num_shots, 1)).astype(np.int32)
    return Acquisition(src_z, src_x, rcv_z, rcv_x)


def marmousi_acoustic_acquisition(nx: int = 200) -> Acquisition:
    """18 shots / 200 receivers on the surface: the canonical Marmousi
    acoustic workload."""
    return surface_line(num_shots=18, num_receivers=200, nx=nx)


def marmousi_elastic_acquisition(nx: int = 300,
                                 dx: float = 20.0) -> Acquisition:
    """35 shots, receiver line at 2-cell depth: the Marmousi elastic
    workload (sources every ~160 m at row 1, receivers every cell at
    row 2).  ``dx`` is accepted for the JAX signature's sake."""
    num_shots = 35
    src_x = np.round(np.linspace(2, nx - 3, num_shots)).astype(np.int32)
    src_z = np.full(num_shots, 1, np.int32)
    rx = np.arange(1, nx - 1, dtype=np.int32)
    rcv_x = np.tile(rx, (num_shots, 1))
    rcv_z = np.full_like(rcv_x, 2)
    return Acquisition(src_z, src_x, rcv_z, rcv_x)


def seam_elastic_acquisition(nx: int = 300) -> Acquisition:
    """SEAM-style geometry at dx=30 m: deeper receivers (row 3, every
    second cell), sparser shots (20)."""
    num_shots = 20
    src_x = np.round(np.linspace(2, nx - 3, num_shots)).astype(np.int32)
    src_z = np.full(num_shots, 1, np.int32)
    rx = np.arange(1, nx - 1, 2, dtype=np.int32)
    rcv_x = np.tile(rx, (num_shots, 1))
    rcv_z = np.full_like(rcv_x, 3)
    return Acquisition(src_z, src_x, rcv_z, rcv_x)
