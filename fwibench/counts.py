"""Operations and bytes of the hand-written kernels, counted from the
scheme at a cell's shapes, and the card's peaks.

Flop per padded cell and time step (recompute not counted): the
acoustic forward 17 and its transpose 20 (kernel B2 = both); the
elastic forward 68 and its transpose 99 (kernel B3 = both).  Bytes are
each input and output once: the coefficient or medium planes, the
wavelet, the observed (and direct-wave) receiver rows in the kernels'
[shots, padded steps, padded columns] layout, the gradient planes.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores (TF32
# off), HBM3 bandwidth; both at the 700 W power limit.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def acoustic_grid(size: dict):
    """(nzp, nxp, nz8, nx128): the model padded by the absorbing layer on
    every side, then to the kernels' multiples of 8 and 128."""
    w = size["pml_width"]
    nzp, nxp = size["nz"] + 2 * w, size["nx"] + 2 * w
    return nzp, nxp, round_up(nzp, 8), round_up(nxp, 128)


def elastic_grid(size: dict):
    """As :func:`acoustic_grid` with a 2-row ring above a free surface."""
    w = size["pml_width"]
    nzp, nxp = size["nz"] + 2 + w, size["nx"] + 2 * w
    return nzp, nxp, round_up(nzp, 8), round_up(nxp, 128)


def b2(size: dict, shots: int, kc: int = 32) -> tuple[float, float]:
    """(flop, bytes) of one call of kernel B2: the acoustic forward
    sweep, the trace-normalized L1 misfit and the reverse sweep."""
    nzp, nxp, nz8, nx128 = acoustic_grid(size)
    nt = size["nt"]
    nt_pad = round_up(nt, kc)
    flop = shots * nzp * nxp * nt * (17 + 20)
    planes = nz8 * nx128
    byts = F32 * (3 * planes + shots * nt_pad + 2 * shots * nt_pad * nx128
                  + shots * nx128 + planes + 1)
    return float(flop), float(byts)


def b3(size: dict, shots: int, kc: int = 8) -> tuple[float, float]:
    """(flop, bytes) of one call of kernel B3: the elastic forward sweep,
    the misfit of vx and vz and the reverse sweep."""
    nzp, nxp, nz8, nx128 = elastic_grid(size)
    nt = size["nt"]
    nt_pad = round_up(nt, kc)
    flop = shots * nzp * nxp * nt * (68 + 99)
    planes = nz8 * nx128
    byts = F32 * (6 * planes + shots * nt_pad + 2 * shots * nt_pad * nx128
                  + shots * nx128 + 5 * planes + 1)
    return float(flop), float(byts)


def bound_s(flop: float, byts: float) -> float:
    """The least time the card could take: the larger of flop over the
    float32 peak and bytes over the memory bandwidth."""
    return max(flop / PEAK_FLOPS, byts / PEAK_BYTES)


def generator_flop(fn, *args) -> float:
    """Flop of ``fn(*args)`` (a forward, or a forward and backward) by
    ``torch.utils.flop_counter`` (convolutions and matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def physics_flop(size: dict, shots: int) -> float:
    """The epoch's physics flop: one B2 or B3 call over ``shots``."""
    if size["physics"] == "acoustic":
        return b2(size, shots)[0]
    return b3(size, shots)[0]

