"""Acquisition geometry as integer cell indices (numpy).

The slice of ``physicsbasedfwi2_tpu/geo/acquisition.py`` that the
acoustic workload uses, copied as it is: geometry stays host-side
numpy and becomes int32 device tensors only where a propagator reads
it.
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
