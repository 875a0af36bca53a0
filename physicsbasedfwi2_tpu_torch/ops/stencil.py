"""Staggered-grid finite-difference derivative operators (port of
``physicsbasedfwi2_tpu/ops/stencil.py``).

Fields are [..., nz, nx]; axis -2 = z (depth), axis -1 = x.
``d{x,z}_fwd`` evaluates the derivative at the staggered (i+1/2)
position; ``d{x,z}_bwd`` at (i-1/2).  Shifts read zeros outside the
array, as the reference's pad-and-slice does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Taylor staggered-grid coefficients.
_COEFFS = {
    2: (1.0,),
    4: (9.0 / 8.0, -1.0 / 24.0),
    8: (1225.0 / 1024.0, -245.0 / 3072.0, 49.0 / 5120.0, -5.0 / 7168.0),
}


def _shift(f: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """f shifted by +k cells along ``axis`` (-1 or -2): out[i] = f[i+k],
    zero-filled."""
    if k == 0:
        return f
    n = f.shape[axis]
    # F.pad lists (left, right) pairs from the last axis backwards
    pad = [0, 0] * (-axis)
    lo = 2 * (-axis - 1)
    if k > 0:
        pad[lo + 1] = k
        return F.pad(f, pad).narrow(axis, k, n)
    pad[lo] = -k
    return F.pad(f, pad).narrow(axis, 0, n)


def _d_fwd(f, axis: int, inv_dx: float, order: int):
    """Forward staggered derivative: sum_m c_m (f[i+m+1] - f[i-m])."""
    out = None
    for m, c in enumerate(_COEFFS[order]):
        term = c * (_shift(f, m + 1, axis) - _shift(f, -m, axis))
        out = term if out is None else out + term
    return out * inv_dx


def _d_bwd(f, axis: int, inv_dx: float, order: int):
    """Backward staggered derivative: sum_m c_m (f[i+m] - f[i-m-1])."""
    out = None
    for m, c in enumerate(_COEFFS[order]):
        term = c * (_shift(f, m, axis) - _shift(f, -m - 1, axis))
        out = term if out is None else out + term
    return out * inv_dx


def dx_fwd(f, inv_dx, order=4):
    return _d_fwd(f, -1, inv_dx, order)


def dx_bwd(f, inv_dx, order=4):
    return _d_bwd(f, -1, inv_dx, order)


def dz_fwd(f, inv_dx, order=4):
    return _d_fwd(f, -2, inv_dx, order)


def dz_bwd(f, inv_dx, order=4):
    return _d_bwd(f, -2, inv_dx, order)
