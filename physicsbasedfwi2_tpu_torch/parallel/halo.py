"""Domain-decomposed acoustic propagation with halo exchange (port of
``physicsbasedfwi2_tpu/parallel/halo.py``).

The reference's only domain decomposition lives inside DENISE (NPROCX x
NPROCY MPI ranks exchanging halos, networks.py:7709-7710).  For grids
larger than one card this module shards the padded grid laterally over a
mesh axis: each rank owns a slab [nzp, nxp / n] (no stored halo) and,
before each x derivative, trades 2-column edge strips with its
neighbours (``dist.batch_isend_irecv``).  The edges are not periodic:
the outer ranks receive zeros, which matches the zero-padded stencils of
the one-card path, so the result equals :func:`simulate_acoustic` up to
float32 reassociation.

Differentiable in ``vp`` and the wavelet: under autograd the time loop
runs on the explicit-parameter checkpointed scan (``cfg.chunk`` steps a
chunk, all shots at once), the exchange's backward is the same exchange
of the cotangents, the gathered rows' backward takes this rank's block,
and the replicated model and wavelet are cut to the rank's slab by
:func:`shard_replicated`, whose backward all-reduces, so every rank ends
with the whole dJ/dvp and dJ/dwavelet.
"""

from __future__ import annotations

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.ops import stencil
from physicsbasedfwi2_tpu_torch.ops.acoustic import (
    AcousticConfig, _damping, _pad_model, edge_pad,
)
from physicsbasedfwi2_tpu_torch.ops.scan_utils import chunked_checkpoint_scan
from physicsbasedfwi2_tpu_torch.parallel.mesh import (
    Mesh, all_gather, exchange, gather_replicated, shard_replicated,
)

HALO = 2  # the 4th-order staggered stencils reach 2 cells


def _dx_dd(diff, f, inv_dx, mesh, axis):
    """``diff`` (a stencil's x derivative) of the slab ``f`` ([..., nz,
    loc_w]) with the neighbours' edge strips as halos."""
    from_prev, from_next = exchange(f[..., :HALO], f[..., -HALO:], mesh,
                                    axis)
    fw = torch.cat([from_prev, f, from_next], dim=-1)
    return diff(fw, inv_dx)[..., HALO:-HALO]


def simulate_acoustic_dd(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                         cfg: AcousticConfig, mesh: Mesh, *,
                         axis: str = "shot"):
    """One shot at a time, the padded grid's x axis sharded over
    ``axis`` of ``mesh`` (padded at the right edge to a multiple of the
    axis).

    The contract of :func:`simulate_acoustic` (receivers [ns, nt, nr]),
    with one restriction: all receivers of a shot sit on one depth row
    (``rcv_z[s, :]`` constant), since each shot records one row.  Every
    rank returns the whole result: the rows are gathered once, after the
    time loop.  Under autograd, with ``vp`` or ``wavelet`` requiring
    grad, every rank runs :func:`_simulate_dd_grad` (all shots at once;
    the backward's collectives run on every rank of the axis in one
    order, so every rank must take the same loss's backward)."""
    rz = np.asarray(torch.as_tensor(rcv_z).cpu())
    if not (rz == rz[:, :1]).all():
        raise ValueError(
            "simulate_acoustic_dd records a single receiver-depth row "
            "per shot; rcv_z must be constant within each shot "
            "(varying-depth geometries would silently return traces "
            "from the wrong cells)")
    wants_grad = torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad
        for a in (vp, wavelet))
    if wants_grad:
        return _simulate_dd_grad(vp, wavelet, src_z, src_x, rz, rcv_x, cfg,
                                 mesh, axis)
    with torch.no_grad():
        return _simulate_dd(vp, wavelet, src_z, src_x, rz, rcv_x, cfg, mesh,
                            axis)


def _slab_coefficients(vp, cfg: AcousticConfig, n: int):
    """kappa_dt and the damping factors on the padded grid, its width
    padded at the right edge (edge values) to a multiple of ``n``."""
    g = cfg.grid
    vp_pad = _pad_model(vp.to(torch.float32), g)
    kappa_dt = vp_pad * vp_pad * g.dt
    ax_v, az_v, ax_p, az_p = _damping(cfg, vp.device)
    nzp, nxp = vp_pad.shape
    if nxp % n:
        pad = n - nxp % n
        kappa_dt = edge_pad(kappa_dt, 0, 0, 0, pad)
        ax_v, ax_p = (edge_pad(a, 0, 0, 0, pad) for a in (ax_v, ax_p))
        nxp += pad
    return kappa_dt, (ax_v, az_v, ax_p, az_p), nzp, nxp


def _simulate_dd_grad(vp, wavelet, src_z, src_x, rz, rcv_x,
                      cfg: AcousticConfig, mesh: Mesh, axis: str):
    """The differentiable path: the step of :func:`_simulate_dd` for all
    shots at once ([ns, nzp, loc_w] fields, one exchange a derivative)
    on :func:`chunked_checkpoint_scan` with explicit parameters, each
    chunk recomputed (its exchanges with it) in the backward pass.  The
    scan runs without CUDA graphs: a collective through the host cannot
    be captured.  Every rank injects at its clamped source column with
    a gain of 0 where the source is not its own (JAX's ``jnp.where``),
    so every rank's graph holds the wavelet."""
    g = cfg.grid
    dev = vp.device
    n = mesh.shape[axis]
    kappa_dt, (ax_v, az_v, ax_p, az_p), nzp, nxp = _slab_coefficients(
        vp, cfg, n)
    loc_w = nxp // n
    lo = mesh.coords[axis] * loc_w
    wav = torch.as_tensor(wavelet, device=dev).to(torch.float32)
    kap, wav = shard_replicated(mesh, axis, [(1, lo, loc_w), None],
                                kappa_dt, wav)
    cols = slice(lo, lo + loc_w)
    axv, axp = (a.expand(nzp, nxp)[:, cols] for a in (ax_v, ax_p))
    azv, azp = (a.expand(nzp, nxp)[:, cols] for a in (az_v, az_p))
    top, w = g.top_pad, g.pml_width
    inv_dx, dt = 1.0 / g.dx, g.dt
    ns = int(src_z.shape[0])
    if wav.ndim == 1:
        wav = wav[None, :].expand(ns, -1)
    sz = torch.as_tensor(src_z, device=dev).long() + top
    sx = torch.as_tensor(src_x, device=dev).long() + w - lo
    mine = ((sx >= 0) & (sx < loc_w)).to(torch.float32)
    # flat cells of the slab: injection a scatter-add, recording a gather
    src = (sz * loc_w + sx.clamp(0, loc_w - 1))[:, None]
    rows = torch.as_tensor(rz[:, 0], device=dev).long() + top
    rec = (rows[:, None] * loc_w
           + torch.arange(loc_w, device=dev)[None, :])
    gain = kap.flatten()[src[:, 0]] * (inv_dx * inv_dx) * mine

    def step(carry, x, params):
        kap_, gain_ = params
        vx, vz, px, pz = carry
        (amp_t,) = x
        p = px + pz
        vx = axv * (vx + dt * _dx_dd(stencil.dx_fwd, p, inv_dx, mesh, axis))
        vz = azv * (vz + dt * stencil.dz_fwd(p, inv_dx))
        px = axp * (px + kap_ * _dx_dd(stencil.dx_bwd, vx, inv_dx, mesh,
                                       axis))
        pz = azp * (pz + kap_ * stencil.dz_bwd(vz, inv_dx))
        pz = pz.flatten(1).scatter_add(1, src, (amp_t * gain_)[:, None]
                                       ).view_as(pz)
        return (vx, vz, px, pz), (px + pz).flatten(1).gather(1, rec)

    zero = torch.zeros((ns, nzp, loc_w), dtype=torch.float32, device=dev)
    _, rows_t = chunked_checkpoint_scan(step, (zero,) * 4, (wav.T,),
                                        chunk=cfg.chunk, params=(kap, gain),
                                        cuda_graphs=False)
    full = gather_replicated(rows_t, mesh, axis, dim=2)  # [nt, ns, nxp]
    cols_r = torch.as_tensor(rcv_x, device=dev).long() + w
    return torch.gather(full.permute(1, 0, 2), 2,
                        cols_r[:, None, :].expand(-1, g.nt, -1))


def _simulate_dd(vp, wavelet, src_z, src_x, rz, rcv_x, cfg: AcousticConfig,
                 mesh: Mesh, axis: str):
    """The path without autograd: one shot at a time, a Python loop of
    time steps."""
    g = cfg.grid
    dev = vp.device
    n = mesh.shape[axis]
    kappa_dt, (ax_v, az_v, ax_p, az_p), nzp, nxp = _slab_coefficients(
        vp, cfg, n)
    loc_w = nxp // n
    lo = mesh.coords[axis] * loc_w
    cols = slice(lo, lo + loc_w)
    kap = kappa_dt[:, cols]
    axv, axp = (a.expand(nzp, nxp)[:, cols] for a in (ax_v, ax_p))
    azv, azp = (a.expand(nzp, nxp)[:, cols] for a in (az_v, az_p))
    top, w = g.top_pad, g.pml_width
    inv_dx, dt = 1.0 / g.dx, g.dt
    wav = wavelet.to(device=dev, dtype=torch.float32)
    outs = []
    for s in range(int(src_z.shape[0])):
        sz, sx = int(src_z[s]) + top, int(src_x[s]) + w - lo
        has_src = 0 <= sx < loc_w
        sx_safe = min(max(sx, 0), loc_w - 1)
        src_gain = kap[sz, sx_safe] * (inv_dx * inv_dx)
        amp = wav[s] if wav.ndim == 2 else wav
        row = int(rz[s, 0]) + top
        vx, vz, px, pz = (torch.zeros_like(kap) for _ in range(4))
        rows = torch.empty((g.nt, loc_w), dtype=torch.float32, device=dev)
        for t in range(g.nt):
            p = px + pz
            vx = axv * (vx + dt * _dx_dd(stencil.dx_fwd, p, inv_dx, mesh,
                                         axis))
            vz = azv * (vz + dt * stencil.dz_fwd(p, inv_dx))
            px = axp * (px + kap * _dx_dd(stencil.dx_bwd, vx, inv_dx, mesh,
                                          axis))
            pz = azp * (pz + kap * stencil.dz_bwd(vz, inv_dx))
            if has_src:
                pz[sz, sx_safe] += amp[t] * src_gain
            rows[t] = (px + pz)[row]
        full = all_gather(rows, mesh, axis, dim=1)
        cols_s = torch.as_tensor(rcv_x[s], device=dev).long() + w
        outs.append(full[:, cols_s])
    return torch.stack(outs)
