"""Differentiable 2D scalar acoustic propagator (port of
``physicsbasedfwi2_tpu/ops/acoustic.py``).

First-order velocity-pressure staggered-grid finite differences
(4th-order space, leapfrog time) with split-field PML, batched over
shots, time-stepped by :func:`chunked_checkpoint_scan`.  The adjoint
(dJ/dvp, and dJ/dwavelet for a floating wavelet) is plain autograd
through the loop, as the JAX package uses autodiff through its scan.
This is the ``"xla"`` backend of :func:`select_acoustic`: plain
PyTorch, not a Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from physicsbasedfwi2_tpu_torch.geo.grid import Grid2D
from physicsbasedfwi2_tpu_torch.ops import pml, stencil
from physicsbasedfwi2_tpu_torch.ops.scan_utils import (
    chunked_checkpoint_scan, closure_scan,
)


@dataclasses.dataclass(frozen=True)
class AcousticConfig:
    """Static propagator configuration."""

    grid: Grid2D
    order: int = 4
    chunk: int = 32
    vmax_pml: float = 5000.0  # velocity used to scale PML profiles


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Replicate-pad the last two axes (``jnp.pad(mode="edge")``)."""
    nz, nx = x.shape[-2:]
    rows = torch.arange(-top, nz + bottom, device=x.device).clamp(0, nz - 1)
    cols = torch.arange(-left, nx + right, device=x.device).clamp(0, nx - 1)
    return x[..., rows, :][..., cols]


def _pad_model(vp: torch.Tensor, grid: Grid2D) -> torch.Tensor:
    w = grid.pml_width
    return edge_pad(vp, grid.top_pad, w, w, w)


def _damping(cfg: AcousticConfig, device):
    """Split-PML decay factors on full- and half-cell positions."""
    g = cfg.grid
    nz, nx = g.padded_shape
    top = 0 if g.free_surface else g.pml_width
    w = g.pml_width
    dt, dx, v = g.dt, g.dx, cfg.vmax_pml

    def prof(n, lo, half):
        return pml.sigma_profile(n, lo, w, dx, v, half_cell=half,
                                 device=device)

    return (
        pml.damping_factors(prof(nx, w, True), dt)[None, :],     # vx
        pml.damping_factors(prof(nz, top, True), dt)[:, None],   # vz
        pml.damping_factors(prof(nx, w, False), dt)[None, :],    # px
        pml.damping_factors(prof(nz, top, False), dt)[:, None],  # pz
    )


def simulate_acoustic(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                      cfg: AcousticConfig) -> torch.Tensor:
    """Simulate a shot gather (differentiable in ``vp`` and
    ``wavelet``).

    Args:
        vp: [nz, nx] velocity in m/s (interior grid, row 0 = surface).
        wavelet: [nt] source time function shared by all shots, or
            [num_shots, nt] per-shot wavelets.
        src_z, src_x: [num_shots] integer source cell indices.
        rcv_z, rcv_x: [num_shots, nr] integer receiver cell indices.
        cfg: static AcousticConfig.

    All tensors on one device.  Returns receivers [num_shots, nt, nr],
    float32; a float64 ``vp`` runs the whole loop in float64 (a
    reference for finite-difference checks).

    Without autograd on a card the loop runs on the explicit-parameter
    scan, each chunk replayed as a CUDA graph; otherwise on
    :func:`closure_scan` (``torch.utils.checkpoint``, differentiable
    twice; forward over reverse on the explicit-parameter scan, for
    ``landscape/hessian.py``).  All give the same bits.
    """
    return _simulate(vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
                     explicit=vp.is_cuda and not torch.is_grad_enabled())


def _simulate(vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg: AcousticConfig,
              *, explicit: bool) -> torch.Tensor:
    """:func:`simulate_acoustic` on the explicit-parameter scan
    (``explicit``) or on :func:`closure_scan`."""
    g = cfg.grid
    dev = vp.device
    dtype = torch.float64 if vp.dtype == torch.float64 else torch.float32
    vp = vp.to(dtype)
    vp_pad = _pad_model(vp, g)
    kappa_dt = (vp_pad * vp_pad) * g.dt  # rho == 1 (scalar medium)
    ax_v, az_v, ax_p, az_p = (d.to(dtype) for d in _damping(cfg, dev))
    top, w = g.top_pad, g.pml_width
    src_z = src_z.long() + top
    src_x = src_x.long() + w
    rcv_z = rcv_z.long() + top
    rcv_x = rcv_x.long() + w
    ns = src_z.shape[0]
    if wavelet.ndim == 1:
        wavelet = wavelet[None, :].expand(ns, -1)
    wavelet = wavelet.to(dtype)

    inv_dx = 1.0 / g.dx
    dt = g.dt
    # flat cells of the padded grid: the injection is a scatter-add and
    # the recording a gather, both capturable in a CUDA graph
    nx_pad = vp_pad.shape[1]
    src = (src_z * nx_pad + src_x)[:, None]
    rcv = rcv_z * nx_pad + rcv_x
    # moment-source injection: amp * dt * kappa / cell-area
    src_gain = kappa_dt.flatten()[src[:, 0]] * (inv_dx * inv_dx)

    def step(carry, x, params):
        kap, gain = params
        vx, vz, px, pz = carry
        (amp_t,) = x
        p = px + pz
        vx = ax_v * (vx + dt * stencil.dx_fwd(p, inv_dx, cfg.order))
        vz = az_v * (vz + dt * stencil.dz_fwd(p, inv_dx, cfg.order))
        px = ax_p * (px + kap * stencil.dx_bwd(vx, inv_dx, cfg.order))
        pz = az_p * (pz + kap * stencil.dz_bwd(vz, inv_dx, cfg.order))
        pz = pz.flatten(1).scatter_add(1, src, (amp_t * gain)[:, None]
                                       ).view_as(pz)
        return (vx, vz, px, pz), (px + pz).flatten(1).gather(1, rcv)

    zero = torch.zeros((ns,) + vp_pad.shape, dtype=dtype, device=dev)
    params = (kappa_dt, src_gain)
    if explicit:
        _, recs = chunked_checkpoint_scan(step, (zero,) * 4, (wavelet.T,),
                                          chunk=cfg.chunk, params=params)
    else:
        _, recs = closure_scan(step, (zero,) * 4, (wavelet.T,), params,
                               chunk=cfg.chunk)
    return recs.permute(1, 0, 2).contiguous()


def acoustic_gradient(vp, loss_fn, wavelet, src_z, src_x, rcv_z, rcv_x,
                      cfg: AcousticConfig):
    """(loss, dJ/dvp) for an arbitrary data-misfit ``loss_fn(pred)``:
    one reverse-mode pass through :func:`simulate_acoustic`, the
    counterpart of the reference's ``lossinner.backward();
    net1out1.grad``.  Both results are detached."""
    with torch.enable_grad():
        v = vp.detach().requires_grad_(True)
        loss = loss_fn(simulate_acoustic(v, wavelet, src_z, src_x, rcv_z,
                                         rcv_x, cfg))
        (grad,) = torch.autograd.grad(loss, v)
    return loss.detach(), grad
