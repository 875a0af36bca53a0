"""2D P-SV elastic propagator, forward only (port of
``physicsbasedfwi2_tpu/ops/elastic.py``).

Virieux velocity-stress staggered grid (4th-order space, leapfrog time)
with split-field PML and an optional stress-free top surface, batched
over shots.  The JAX package differentiates this scheme with autodiff;
on the ported path it only makes the synthetic workload's observed data
(which the engine then replaces with the fused kernel's own operator,
:func:`ops.elastic_fused.simulate_elastic_ring`), so the port runs it
under ``no_grad`` in plain PyTorch.  It is not a Pallas kernel.

Staggering (Virieux 1986):
    sxx, szz at (i, j);  sxz at (i+1/2, j+1/2)
    vx at (i, j+1/2);    vz at (i+1/2, j)
"""

from __future__ import annotations

import dataclasses

import torch

from physicsbasedfwi2_tpu_torch.geo.grid import Grid2D
from physicsbasedfwi2_tpu_torch.ops import pml
from physicsbasedfwi2_tpu_torch.ops.acoustic import edge_pad
from physicsbasedfwi2_tpu_torch.ops.stencil import (
    dx_bwd, dx_fwd, dz_bwd, dz_fwd,
)


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    grid: Grid2D
    order: int = 4
    chunk: int = 32
    vmax_pml: float = 5000.0


def _pad(m: torch.Tensor, grid: Grid2D) -> torch.Tensor:
    w = grid.pml_width
    return edge_pad(m, grid.top_pad, w, w, w)


def _damping(cfg: ElasticConfig, device):
    """Split-PML decay factors on full- and half-cell positions:
    (ax_f [1, nx], ax_h [1, nx], az_f [nz, 1], az_h [nz, 1])."""
    g = cfg.grid
    nz, nx = g.padded_shape
    top = 0 if g.free_surface else g.pml_width
    w = g.pml_width
    dt, dx, v = g.dt, g.dx, cfg.vmax_pml

    def fac(n, lo, half):
        return pml.damping_factors(pml.sigma_profile(
            n, lo, w, dx, v, half_cell=half, device=device), dt)

    return (fac(nx, w, False)[None, :], fac(nx, w, True)[None, :],
            fac(nz, top, False)[:, None], fac(nz, top, True)[:, None])


def _roll_up(m: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.roll(m, -1, axis)``: out[i] = m[i+1], circularly."""
    return torch.roll(m, -1, dims=axis)


def _staggered_medium(vp, vs, rho):
    """Lame parameters and buoyancies at their staggered positions:
    (lam, mu, mu_xz, bx, bz).  Differentiable; the circular rolls and
    the double ``where`` for fluid cells are the JAX package's, so the
    gradient through them is the same."""
    mu = rho * vs * vs
    lam = rho * (vp * vp - 2.0 * vs * vs)
    # buoyancy at vx (i, j+1/2): average along x; at vz (i+1/2, j): along z
    b = 1.0 / rho
    bx = 0.5 * (b + _roll_up(b, -1))
    bz = 0.5 * (b + _roll_up(b, -2))
    # mu at sxz (i+1/2, j+1/2): harmonic mean of 4 neighbours; any fluid
    # neighbour (mu = 0) makes it 0, with a zero (not inf) gradient
    m1, m2, m3 = mu, _roll_up(mu, -2), _roll_up(mu, -1)
    m4 = _roll_up(_roll_up(mu, -2), -1)
    mn = torch.minimum(torch.minimum(m1, m2), torch.minimum(m3, m4))
    solid = mn > 1e-3
    one = torch.ones_like(mu)
    safe = [torch.where(solid, m, one) for m in (m1, m2, m3, m4)]
    mu_h = 4.0 / (1.0 / safe[0] + 1.0 / safe[1]
                  + 1.0 / safe[2] + 1.0 / safe[3])
    mu_xz = torch.where(solid, mu_h, torch.zeros_like(mu_h))
    return lam, mu, mu_xz, bx, bz


@torch.no_grad()
def simulate_elastic(vp, vs, rho, wavelet, src_z, src_x, rcv_z, rcv_x,
                     cfg: ElasticConfig):
    """Simulate an elastic shot gather.

    Args:
        vp, vs, rho: [nz, nx] SI medium (row 0 = surface).
        wavelet: [nt] or [num_shots, nt] source time function.
        src_z, src_x: [num_shots] integer source cells;
        rcv_z, rcv_x: [num_shots, nr] integer receiver cells.

    All tensors on one device.  Returns (vx, vz) receiver traces, each
    [num_shots, nt, nr] float32.
    """
    g = cfg.grid
    dev = vp.device
    vp, vs, rho = (_pad(a.to(torch.float32), g) for a in (vp, vs, rho))
    lam, mu, mu_xz, bx, bz = _staggered_medium(vp, vs, rho)
    ax_f, ax_h, az_f, az_h = _damping(cfg, dev)
    top, w = g.top_pad, g.pml_width
    src_z = src_z.long() + top
    src_x = src_x.long() + w
    rcv_z = rcv_z.long() + top
    rcv_x = rcv_x.long() + w
    ns = src_z.shape[0]
    if wavelet.ndim == 1:
        wavelet = wavelet[None, :].expand(ns, -1)
    wavelet = wavelet.to(torch.float32)
    dt, inv_dx, order = g.dt, 1.0 / g.dx, cfg.order
    lam2mu = lam + 2.0 * mu
    # moment-source scaling by the P-modulus at the source
    src_gain = dt * inv_dx * inv_dx * lam2mu[src_z, src_x]
    shot = torch.arange(ns, device=dev)
    zeros = torch.zeros((ns,) + vp.shape, dtype=torch.float32, device=dev)
    vxx, vxz, vzx, vzz, sxxx, sxxz, szzx, szzz, sxzx, sxzz = (
        zeros.clone() for _ in range(10))
    rvx = torch.empty((ns, g.nt, rcv_x.shape[1]), dtype=torch.float32,
                      device=dev)
    rvz = torch.empty_like(rvx)
    for t in range(g.nt):
        sxx = sxxx + sxxz
        szz = szzx + szzz
        sxz = sxzx + sxzz
        # velocity updates
        vxx = ax_h * (vxx + dt * bx * dx_fwd(sxx, inv_dx, order))
        vxz = az_f * (vxz + dt * bx * dz_bwd(sxz, inv_dx, order))
        vzx = ax_f * (vzx + dt * bz * dx_bwd(sxz, inv_dx, order))
        vzz = az_h * (vzz + dt * bz * dz_fwd(szz, inv_dx, order))
        vx = vxx + vxz
        vz = vzx + vzz
        # stress updates
        dvxdx = dx_bwd(vx, inv_dx, order)
        dvzdz = dz_bwd(vz, inv_dx, order)
        sxxx = ax_f * (sxxx + dt * lam2mu * dvxdx)
        sxxz = az_f * (sxxz + dt * lam * dvzdz)
        szzx = ax_f * (szzx + dt * lam * dvxdx)
        szzz = az_f * (szzz + dt * lam2mu * dvzdz)
        sxzx = ax_h * (sxzx + dt * mu_xz * dx_fwd(vz, inv_dx, order))
        sxzz = az_h * (sxzz + dt * mu_xz * dz_fwd(vx, inv_dx, order))
        # explosive source into the normal stresses
        amp = wavelet[:, t] * src_gain
        sxxx[shot, src_z, src_x] += amp
        szzz[shot, src_z, src_x] += amp
        if g.free_surface:
            # stress-free surface: szz = 0 on row 0
            szzx[:, 0, :] = 0.0
            szzz[:, 0, :] = 0.0
        rvx[:, t] = vx[shot[:, None], rcv_z, rcv_x]
        rvz[:, t] = vz[shot[:, None], rcv_z, rcv_x]
    return rvx, rvz
