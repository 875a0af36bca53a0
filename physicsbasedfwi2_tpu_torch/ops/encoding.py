"""Simultaneous-source (super-shot) encoding (port of
``physicsbasedfwi2_tpu/ops/encoding.py``).

Many physical shots combine into a few random-polarity super-shots
(Krebs et al. 2009), cutting the simulations of an iteration by the
encoding factor.  The estimator is unbiased over encodings for a
quadratic misfit and receivers common to all shots.

A super-shot is the acoustic scheme of :func:`ops.acoustic.
simulate_acoustic` with a multi-point source: one scatter-add a step.
The loop runs on :func:`chunked_checkpoint_scan` with explicit
parameters (the medium and the source gains), so on a card each chunk
replays as a CUDA graph.  Plain PyTorch under autograd, no kernel.
"""

from __future__ import annotations

import torch

from physicsbasedfwi2_tpu_torch.ops import stencil
from physicsbasedfwi2_tpu_torch.ops.acoustic import (
    AcousticConfig, _damping, _pad_model,
)
from physicsbasedfwi2_tpu_torch.ops.misfit import l1_misfit, l2_misfit
from physicsbasedfwi2_tpu_torch.ops.scan_utils import chunked_checkpoint_scan


def encode_shots(ns: int, n_super: int, generator: torch.Generator):
    """Randomly partition ``ns`` shots into ``n_super`` groups with
    Rademacher polarities drawn from ``generator``.

    Returns (groups int64, pol float32), each [n_super, k] on the
    generator's device, k = ceil(ns / n_super): a permutation of the
    shots padded with its first shots, the padded duplicates at polarity
    0.  The JAX package draws from a ``jax.random`` key, so the two
    packages encode differently from the same seed."""
    k = -(-ns // n_super)
    dev = generator.device
    perm = torch.randperm(ns, generator=generator, device=dev)
    pad = n_super * k - ns
    groups = torch.cat([perm, perm[:pad]]).reshape(n_super, k)
    pol = (2.0 * torch.randint(0, 2, (n_super, k), generator=generator,
                               device=dev) - 1.0).float()
    if pad:
        valid = torch.arange(n_super * k, device=dev).reshape(n_super, k) < ns
        pol = pol * valid
    return groups, pol


def simulate_acoustic_encoded(vp, wavelet, enc_z, enc_x, pol, rcv_z, rcv_x,
                              cfg: AcousticConfig) -> torch.Tensor:
    """Simulate encoded super-shots (differentiable in ``vp`` and the
    wavelet).

    Args:
        vp: [nz, nx] velocity.
        wavelet: [nt] shared, or [n_super, nt].
        enc_z, enc_x: [n_super, k] source cells of each super-shot.
        pol: [n_super, k] polarities (0 silences a source).
        rcv_z, rcv_x: [n_super, nr] receiver cells (usually the common
            spread repeated).

    Returns [n_super, nt, nr] traces; a float64 ``vp`` runs the loop in
    float64.
    """
    g = cfg.grid
    dev = vp.device
    dtype = torch.float64 if vp.dtype == torch.float64 else torch.float32
    vp_pad = _pad_model(vp.to(dtype), g)
    kappa_dt = (vp_pad * vp_pad) * g.dt
    ax_v, az_v, ax_p, az_p = (d.to(dtype) for d in _damping(cfg, dev))
    top, w = g.top_pad, g.pml_width
    nx_pad = vp_pad.shape[1]
    # flat cells of the padded grid: the injection is a scatter-add and
    # the recording a gather, both capturable in a CUDA graph
    src = (enc_z.long() + top) * nx_pad + (enc_x.long() + w)
    rcv = (rcv_z.long() + top) * nx_pad + (rcv_x.long() + w)
    n_super = src.shape[0]
    if wavelet.ndim == 1:
        wavelet = wavelet[None, :].expand(n_super, -1)
    wavelet = wavelet.to(dtype)
    inv_dx = 1.0 / g.dx
    dt = g.dt
    # moment-source gain at each source cell, times its polarity
    gains = kappa_dt.flatten()[src] * (inv_dx * inv_dx) * pol.to(dtype)

    def step(carry, x, params):
        kap, gain = params
        vx, vz, px, pz = carry
        (amp_t,) = x
        p = px + pz
        vx = ax_v * (vx + dt * stencil.dx_fwd(p, inv_dx, cfg.order))
        vz = az_v * (vz + dt * stencil.dz_fwd(p, inv_dx, cfg.order))
        px = ax_p * (px + kap * stencil.dx_bwd(vx, inv_dx, cfg.order))
        pz = az_p * (pz + kap * stencil.dz_bwd(vz, inv_dx, cfg.order))
        pz = pz.flatten(1).scatter_add(1, src, amp_t[:, None] * gain
                                       ).view_as(pz)
        return (vx, vz, px, pz), (px + pz).flatten(1).gather(1, rcv)

    zero = torch.zeros((n_super,) + vp_pad.shape, dtype=dtype, device=dev)
    _, recs = chunked_checkpoint_scan(step, (zero,) * 4, (wavelet.T,),
                                      chunk=cfg.chunk,
                                      params=(kappa_dt, gains))
    return recs.permute(1, 0, 2).contiguous()


def encoded_fwi_gradient(vp, obs, wavelet, src_z, src_x, rcv_z, rcv_x,
                         cfg: AcousticConfig, n_super: int, *,
                         generator: torch.Generator | None = None,
                         groups=None, pol=None, misfit: str = "l2"):
    """(loss, dJ/dvp) on encoded super-shots, both detached.

    The encoding is ``groups``/``pol`` where given (as
    :func:`encode_shots` returns them), else a fresh draw from
    ``generator``.  The observed super-gathers are the same polarity
    combination of the per-shot ``obs`` [ns, nt, nr] (the wave equation
    is linear in the source); every super-shot records on shot 0's
    receiver spread, so the receivers must be common to all shots."""
    if groups is None:
        groups, pol = encode_shots(int(src_z.shape[0]), n_super, generator)
    dev = vp.device
    groups = groups.to(dev)
    pol = pol.to(dev, obs.dtype)
    obs_enc = torch.einsum("gk,gktr->gtr", pol, obs[groups])
    rz = rcv_z[:1].expand(n_super, -1)
    rx = rcv_x[:1].expand(n_super, -1)
    mis = l1_misfit if misfit == "l1" else l2_misfit
    with torch.enable_grad():
        v = vp.detach().requires_grad_(True)
        pred = simulate_acoustic_encoded(v, wavelet, src_z[groups],
                                         src_x[groups], pol, rz, rx, cfg)
        loss = mis(pred, obs_enc)
        (grad,) = torch.autograd.grad(loss, v)
    return loss.detach(), grad
