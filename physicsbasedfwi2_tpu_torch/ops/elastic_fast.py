"""Fast-path elastic propagator: unsplit fields and a Kosloff sponge
(port of ``physicsbasedfwi2_tpu/ops/elastic_fast.py``).

The split-field PML scheme of :mod:`ops.elastic` carries 10 state
fields; this one carries 5 (vx, vz, sxx, szz, sxz) with a multiplicative
sponge decay: half the state updates and half the checkpoint memory of
backpropagation through time.  The sponge reflects a little more than
the PML, which does not matter for inversion as long as the observed
and predicted data come from the same operator (the elastic engine
regenerates synthetic data with it).

Virieux P-SV velocity-stress staggered grid, with the staggering and
medium averaging of :mod:`ops.elastic` (free surface: szz row 0 held at
0), batched over shots.  The gradient is plain autograd through
:func:`chunked_checkpoint_scan`: the elastic engine's ``"fast"`` path.
It is not a Pallas kernel.
"""

from __future__ import annotations

import torch

from physicsbasedfwi2_tpu_torch.ops import pml
from physicsbasedfwi2_tpu_torch.ops.elastic import (
    ElasticConfig, _flat_cells, _free_surface_row, _geometry, _inject, _pad,
    _record, _staggered_medium, _traces,
)
from physicsbasedfwi2_tpu_torch.ops.scan_utils import chunked_checkpoint_scan
from physicsbasedfwi2_tpu_torch.ops.stencil import (
    dx_bwd, dx_fwd, dz_bwd, dz_fwd,
)


def _sponge(cfg: ElasticConfig, device) -> torch.Tensor:
    """[nz, nx] per-step decay: exp(-(sz + sx) dt) with half the PML's
    sigma (a sponge as strong as the PML over-reflects); no decay at a
    free surface's top."""
    g = cfg.grid
    nz, nx = g.padded_shape
    top = 0 if g.free_surface else g.pml_width
    w = g.pml_width
    sx = pml.sigma_profile(nx, w, w, g.dx, cfg.vmax_pml, device=device) * 0.5
    sz = pml.sigma_profile(nz, top, w, g.dx, cfg.vmax_pml,
                           device=device) * 0.5
    return torch.exp(-(sz[:, None] + sx[None, :]) * g.dt)


def _step_params(med, src_z, src_x, cfg: ElasticConfig):
    """The medium as the step reads it: (lam, lam + 2 mu, dt mu_xz,
    dt bx, dt bz, the per-shot source gain dt lam2mu / dx^2 at the
    source), the products formed once, in the order the JAX step forms
    them each step."""
    g = cfg.grid
    dt, inv_dx = g.dt, 1.0 / g.dx
    lam, mu, mu_xz, bx, bz = med
    lam2mu = lam + 2.0 * mu
    # moment-source scaling by the P-modulus at the source
    src_gain = dt * inv_dx * inv_dx * lam2mu[src_z, src_x]
    return lam, lam2mu, dt * mu_xz, dt * bx, dt * bz, src_gain


def _virieux_step(damp, free_surface: bool, src_z, src_x,
                  cfg: ElasticConfig):
    """The Virieux P-SV velocity-stress time step of every shot at once:
    ``step((vx, vz, sxx, szz, sxz), amp_t, params) -> fields``, the
    fields [num_shots, nz, nx], ``amp_t`` the wavelet sample of each
    shot, ``params`` :func:`_step_params`' tuple, and ``src_z``/``src_x``
    the shots' source cells in the padded grid.

    Shared by :func:`simulate_elastic_fast` and
    :func:`elastic_illumination`, so the illumination map comes from the
    operator of the gradient it would divide.  Every update is out of
    place: autograd keeps the fields of the steps it recomputes."""
    g = cfg.grid
    dt, inv_dx, order = g.dt, 1.0 / g.dx, cfg.order
    src = _flat_cells(src_z, src_x, damp.shape[1])
    row0 = (_free_surface_row(damp.shape, damp.device) if free_surface
            else None)

    def step(fields, amp_t, params):
        lam, lam2mu, dt_mu_xz, dt_bx, dt_bz, src_gain = params
        vx, vz, sxx, szz, sxz = fields
        vx = damp * (vx + dt_bx * (dx_fwd(sxx, inv_dx, order)
                                   + dz_bwd(sxz, inv_dx, order)))
        vz = damp * (vz + dt_bz * (dx_bwd(sxz, inv_dx, order)
                                   + dz_fwd(szz, inv_dx, order)))
        dvxdx = dx_bwd(vx, inv_dx, order)
        dvzdz = dz_bwd(vz, inv_dx, order)
        sxx = damp * (sxx + dt * (lam2mu * dvxdx + lam * dvzdz))
        szz = damp * (szz + dt * (lam * dvxdx + lam2mu * dvzdz))
        sxz = damp * (sxz + dt_mu_xz * (dx_fwd(vz, inv_dx, order)
                                        + dz_fwd(vx, inv_dx, order)))
        # explosive source into the normal stresses
        amp = amp_t * src_gain
        sxx = _inject(sxx, src, amp)
        szz = _inject(szz, src, amp)
        if row0 is not None:
            szz = torch.where(row0, 0.0, szz)
        return (vx, vz, sxx, szz, sxz)

    return step


def _medium(vp, vs, rho, cfg: ElasticConfig, dtype):
    g = cfg.grid
    return _staggered_medium(*(_pad(a.to(dtype), g) for a in (vp, vs, rho)))


def simulate_elastic_fast(vp, vs, rho, wavelet, src_z, src_x, rcv_z,
                          rcv_x, cfg: ElasticConfig):
    """The contract of :func:`ops.elastic.simulate_elastic` ((vx, vz)
    traces, each [num_shots, nt, nr]; any receiver rows, a cell may
    repeat) on the 5-field sponge scheme, differentiable in vp, vs, rho
    and the wavelet.  A float64 ``vp`` runs the loop in float64."""
    g = cfg.grid
    dev = vp.device
    dtype = torch.float64 if vp.dtype == torch.float64 else torch.float32
    med = _medium(vp, vs, rho, cfg, dtype)
    damp = _sponge(cfg, dev).to(dtype)
    src_z, src_x, rcv_z, rcv_x, wavelet = _geometry(
        g, src_z, src_x, rcv_z, rcv_x, wavelet, dtype)
    vstep = _virieux_step(damp, g.free_surface, src_z, src_x, cfg)
    rcv = _flat_cells(rcv_z, rcv_x, damp.shape[1])

    def step(carry, x, params):
        fields = vstep(carry, x[0], params)
        return fields, _record(fields[0], fields[1], rcv)

    zero = torch.zeros((src_z.shape[0],) + med[0].shape, dtype=dtype,
                       device=dev)
    _, recs = chunked_checkpoint_scan(
        step, (zero,) * 5, (wavelet.T,), chunk=cfg.chunk,
        params=_step_params(med, src_z, src_x, cfg))
    return _traces(recs)


@torch.no_grad()
def elastic_illumination(vp, vs, rho, wavelet, src_z, src_x,
                         cfg: ElasticConfig) -> torch.Tensor:
    """Source-side illumination map: the sum over shots and time steps
    of the forward particle-velocity energy vx^2 + vz^2, on the interior
    grid [nz, nx] (DENISE's EPRECOND Hessian-diagonal approximation).
    Forward only: a plain loop, no checkpoints, no gradient."""
    g = cfg.grid
    med = _medium(vp, vs, rho, cfg, torch.float32)
    damp = _sponge(cfg, vp.device)
    src_z, src_x, _, _, wavelet = _geometry(
        g, src_z, src_x, src_z[:, None], src_x[:, None], wavelet,
        torch.float32)
    vstep = _virieux_step(damp, g.free_surface, src_z, src_x, cfg)
    params = _step_params(med, src_z, src_x, cfg)
    fields = (torch.zeros((src_z.shape[0],) + med[0].shape,
                          dtype=torch.float32, device=vp.device),) * 5
    acc = torch.zeros_like(fields[0])
    for t in range(wavelet.shape[1]):
        fields = vstep(fields, wavelet[:, t], params)
        acc = acc + fields[0] * fields[0] + fields[1] * fields[1]
    nz, nx = g.shape
    top, w = g.top_pad, g.pml_width
    return acc.sum(0)[top: top + nz, w: w + nx]
