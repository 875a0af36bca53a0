"""Differentiable 2D P-SV elastic propagator (port of
``physicsbasedfwi2_tpu/ops/elastic.py``).

Virieux velocity-stress staggered grid (4th-order space, leapfrog time)
with split-field PML and an optional stress-free top surface, batched
over shots, time-stepped by :func:`chunked_checkpoint_scan`.  The
gradient (:func:`elastic_gradient`) is plain autograd through the loop,
as the JAX package uses autodiff through its scan: the elastic engine's
``"xla"`` path.  It also makes the synthetic workload's observed data
(under ``no_grad``).  It is not a Pallas kernel.

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
from physicsbasedfwi2_tpu_torch.ops.scan_utils import chunked_checkpoint_scan
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


def _geometry(g: Grid2D, src_z, src_x, rcv_z, rcv_x, wavelet, dtype):
    """Source and receiver cells moved into the padded grid (int64), and
    the wavelet as [num_shots, nt] of ``dtype``."""
    top, w = g.top_pad, g.pml_width
    src_z = src_z.long() + top
    src_x = src_x.long() + w
    rcv_z = rcv_z.long() + top
    rcv_x = rcv_x.long() + w
    if wavelet.ndim == 1:
        wavelet = wavelet[None, :].expand(src_z.shape[0], -1)
    return src_z, src_x, rcv_z, rcv_x, wavelet.to(dtype)


def _free_surface_row(shape, device) -> torch.Tensor:
    """[nz, 1] mask of row 0, where a free surface holds szz at 0."""
    row = torch.zeros((shape[0], 1), dtype=torch.bool, device=device)
    row[0] = True
    return row


def _flat_cells(z, x, nx: int) -> torch.Tensor:
    """Cells (z, x) of each shot's padded grid as flat indices
    [num_shots, k] (``z`` and ``x`` [num_shots] or [num_shots, k])."""
    idx = z * nx + x
    return idx[:, None] if idx.ndim == 1 else idx


def _inject(f, src, amp) -> torch.Tensor:
    """f [num_shots, nz, nx] plus each shot's ``amp`` at its source cell
    (``src`` from :func:`_flat_cells`), out of place.  A scatter-add on
    the flat grid (and gathers in :func:`_record`), not advanced
    indexing, whose backward sorts: every op of a step stays capturable
    in a CUDA graph."""
    return f.flatten(1).scatter_add(1, src, amp[:, None]).view_as(f)


def _record(vx, vz, rcv) -> torch.Tensor:
    """Receiver samples of one step: [2, num_shots, nr] (vx, vz) at the
    flat cells ``rcv`` [num_shots, nr]; any receiver rows, repeated
    cells allowed."""
    return torch.stack([vx.flatten(1).gather(1, rcv),
                        vz.flatten(1).gather(1, rcv)])


def _traces(recs: torch.Tensor):
    """[nt, 2, num_shots, nr] step records -> (vx, vz), each
    [num_shots, nt, nr]."""
    recs = recs.permute(1, 2, 0, 3)
    return recs[0].contiguous(), recs[1].contiguous()


def simulate_elastic(vp, vs, rho, wavelet, src_z, src_x, rcv_z, rcv_x,
                     cfg: ElasticConfig):
    """Simulate an elastic shot gather (differentiable in vp, vs, rho
    and the wavelet).

    Args:
        vp, vs, rho: [nz, nx] SI medium (row 0 = surface).
        wavelet: [nt] or [num_shots, nt] source time function.
        src_z, src_x: [num_shots] integer source cells;
        rcv_z, rcv_x: [num_shots, nr] integer receiver cells (any rows;
            a cell may repeat).

    All tensors on one device.  The time loop runs through
    :func:`chunked_checkpoint_scan` (``cfg.chunk`` steps a checkpoint),
    as the JAX package's ``lax.scan`` under remat.  Returns (vx, vz)
    receiver traces, each [num_shots, nt, nr], float32; a float64 ``vp``
    runs the whole loop in float64 (a reference for finite-difference
    checks).
    """
    g = cfg.grid
    dev = vp.device
    dtype = torch.float64 if vp.dtype == torch.float64 else torch.float32
    vp, vs, rho = (_pad(a.to(dtype), g) for a in (vp, vs, rho))
    lam, mu, mu_xz, bx, bz = _staggered_medium(vp, vs, rho)
    ax_f, ax_h, az_f, az_h = (d.to(dtype) for d in _damping(cfg, dev))
    src_z, src_x, rcv_z, rcv_x, wavelet = _geometry(
        g, src_z, src_x, rcv_z, rcv_x, wavelet, dtype)
    ns = src_z.shape[0]
    dt, inv_dx, order = g.dt, 1.0 / g.dx, cfg.order
    lam2mu = lam + 2.0 * mu
    # moment-source scaling by the P-modulus at the source
    src_gain = dt * inv_dx * inv_dx * lam2mu[src_z, src_x]
    src = _flat_cells(src_z, src_x, vp.shape[1])
    rcv = _flat_cells(rcv_z, rcv_x, vp.shape[1])
    row0 = _free_surface_row(vp.shape, dev) if g.free_surface else None

    def step(carry, x, params):
        # dt bx, dt bz formed once: the products the JAX step forms
        lam, lam2mu, mu_xz, dt_bx, dt_bz, src_gain = params
        vxx, vxz, vzx, vzz, sxxx, sxxz, szzx, szzz, sxzx, sxzz = carry
        (amp_t,) = x
        sxx = sxxx + sxxz
        szz = szzx + szzz
        sxz = sxzx + sxzz
        # velocity updates
        vxx = ax_h * (vxx + dt_bx * dx_fwd(sxx, inv_dx, order))
        vxz = az_f * (vxz + dt_bx * dz_bwd(sxz, inv_dx, order))
        vzx = ax_f * (vzx + dt_bz * dx_bwd(sxz, inv_dx, order))
        vzz = az_h * (vzz + dt_bz * dz_fwd(szz, inv_dx, order))
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
        # explosive source into the normal stresses (out of place:
        # autograd keeps the fields of every step it recomputes)
        amp = amp_t * src_gain
        sxxx = _inject(sxxx, src, amp)
        szzz = _inject(szzz, src, amp)
        if row0 is not None:
            # stress-free surface: szz = 0 on row 0
            szzx = torch.where(row0, 0.0, szzx)
            szzz = torch.where(row0, 0.0, szzz)
        carry = (vxx, vxz, vzx, vzz, sxxx, sxxz, szzx, szzz, sxzx, sxzz)
        return carry, _record(vx, vz, rcv)

    zero = torch.zeros((ns,) + vp.shape, dtype=dtype, device=dev)
    _, recs = chunked_checkpoint_scan(
        step, (zero,) * 10, (wavelet.T,), chunk=cfg.chunk,
        params=(lam, lam2mu, mu_xz, dt * bx, dt * bz, src_gain))
    return _traces(recs)


def elastic_gradient(vp, vs, rho, loss_fn, wavelet, src_z, src_x,
                     rcv_z, rcv_x, cfg: ElasticConfig,
                     wrt=("vp", "vs", "rho")):
    """(loss, {name: dJ/dname}) for a data misfit ``loss_fn((vx, vz))``:
    one reverse-mode pass through :func:`simulate_elastic` with respect
    to the fields named in ``wrt``.  Both results are detached."""
    names = ("vp", "vs", "rho")
    with torch.enable_grad():
        fields = [f.detach().requires_grad_(n in wrt)
                  for n, f in zip(names, (vp, vs, rho))]
        loss = loss_fn(simulate_elastic(*fields, wavelet, src_z, src_x,
                                        rcv_z, rcv_x, cfg))
        want = [f for n, f in zip(names, fields) if n in wrt]
        grads = torch.autograd.grad(loss, want)
    return loss.detach(), dict(zip([n for n in names if n in wrt], grads))
