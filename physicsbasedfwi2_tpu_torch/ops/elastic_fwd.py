"""Forward-only elastic propagator (kernel B8, ``elastic_forward_pallas``).

Port of ``physicsbasedfwi2_tpu/ops/pallas_elastic.py`` (``_prepare_el``,
``elastic_forward_pallas``; Pallas kernel ``_el_kernel``).  The 5-field
P-SV velocity-stress scheme with a Kosloff sponge (a per-step decay
``damp = exp(-(sz + sx)/2 dt)``, times a 2-cell zero ring that stands in
for the Pallas kernel's circular rolls), 4th-order staggered
derivatives, an explosive source on sxx and szz with gain
dt/dx^2 l2m[src], and both receiver rows (vx, vz) recorded every step.
Absorbing tops only: a free surface raises, as in the JAX package.

It is the function of :func:`ops.elastic_fused.simulate_elastic_ring`
without the free-surface row, so its plain version is that module's
plain forward scan and on CUDA tensors :func:`elastic_forward_pallas`
launches that function's hand-written kernels
(:func:`ops.elastic_fused.forward_rows_cuda` with no free-surface row):
where :func:`ops.elastic_fused.elastic_forward_plan` holds the grid the
resident route (``csrc/elastic.cu::b3_elastic_ring_resident``, one
thread-block cluster per shot holds its fields in shared memory for the
whole time loop), elsewhere the per-step route (``b3_elastic_ring``).
On CPU tensors it runs :func:`elastic_forward_pallas_plain`.
"""

from __future__ import annotations

from functools import partial

import torch

from physicsbasedfwi2_tpu_torch.ops import pml
from physicsbasedfwi2_tpu_torch.ops.acoustic import edge_pad
from physicsbasedfwi2_tpu_torch.ops.elastic import (
    ElasticConfig, _pad, _staggered_medium,
)
from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
    _rows_plain, forward_rows_cuda,
)
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    _kernel_route, _round_up, reset_launches,
)


def _prepare_el(vp, vs, rho, cfg: ElasticConfig):
    """(lam, l2m, muxz, bx, bz) and the sponge decay times the zero ring,
    each [nz8, nx128] float32 on vp's device, and (nz8, nx128)."""
    g = cfg.grid
    dev = vp.device
    vp_p, vs_p, rho_p = (_pad(a.to(torch.float32), g) for a in (vp, vs, rho))
    lam, mu, mu_xz, bx, bz = _staggered_medium(vp_p, vs_p, rho_p)
    nzp, nxp = vp_p.shape
    nz8, nx128 = _round_up(nzp, 8), _round_up(nxp, 128)

    def padp(a):
        return edge_pad(a, 0, nz8 - nzp, 0, nx128 - nxp)

    # sponge: sum of axis profiles, as a per-step decay factor
    top = 0 if g.free_surface else g.pml_width
    w = g.pml_width
    sx = pml.sigma_profile(nxp, w, w, g.dx, cfg.vmax_pml, device=dev) * 0.5
    sz = pml.sigma_profile(nzp, top, w, g.dx, cfg.vmax_pml, device=dev) * 0.5
    damp = torch.exp(-(sz[:, None] + sx[None, :]) * g.dt)
    rows = torch.zeros((nz8, 1), dtype=torch.float32, device=dev)
    rows[2: nzp - 2] = 1.0
    cols = torch.zeros((1, nx128), dtype=torch.float32, device=dev)
    cols[0, 2: nxp - 2] = 1.0
    damp = padp(damp) * (rows * cols)
    meds = tuple(padp(m) for m in (lam, lam + 2.0 * mu, mu_xz, bx, bz))
    return meds, damp, (nz8, nx128)


def _geometry(cfg, l2m, wavelet, src_z, src_x, rcv_z):
    """Per-shot wavelet [ns, nt], padded int32 source cells and receiver
    rows, and the source gain dt/dx^2 l2m[src] [ns]."""
    g = cfg.grid
    dev = l2m.device
    ns = int(src_z.shape[0])
    wav = torch.as_tensor(wavelet, device=dev).to(torch.float32)
    if wav.ndim == 1:
        wav = wav[None, :].expand(ns, g.nt)
    top, w = g.top_pad, g.pml_width

    def idx(a, off):
        return (torch.as_tensor(a, device=dev).to(torch.int32)
                + off).contiguous()

    sz, sx = idx(src_z, top), idx(src_x, w)
    rrow = idx(torch.as_tensor(rcv_z)[:, 0], top)
    inv_dx = 1.0 / g.dx
    gain = (g.dt * inv_dx * inv_dx) * l2m[sz.long(), sx.long()]
    return wav.contiguous(), sz, sx, rrow, gain.contiguous()


def _rows_open_top(meds, damp, wav, sz, sx, rrow, gain, nt, dtx):
    """The ring forward's plain scan with no free-surface row."""
    return _rows_plain(meds, damp, wav, sz, sx, rrow, gain, -1, nt, dtx)


def _rows_cuda(meds, damp, wav, sz, sx, rrow, gain, nt, dtx, route=None):
    """The ring forward's kernels with no free-surface row."""
    return forward_rows_cuda(elastic_forward_pallas, meds, damp, wav, sz, sx,
                             rrow, gain, -1, nt, dtx, route)


def _forward(rows_fn, vp, vs, rho, wavelet, src_z, src_x, rcv_z, rcv_x, cfg):
    g = cfg.grid
    if g.free_surface:
        # the zero ring that stands in for circular rolls clamps the top
        # two rows: a rigid, not a free, surface (pallas_elastic.py:145)
        raise NotImplementedError(
            "the elastic forward kernel supports absorbing tops only; use "
            "simulate_elastic_ring or simulate_elastic for free-surface "
            "workloads")
    meds, damp, _ = _prepare_el(vp, vs, rho, cfg)
    wav, sz, sx, rrow, gain = _geometry(cfg, meds[1], wavelet, src_z, src_x,
                                        rcv_z)
    hx, hz = rows_fn(meds, damp, wav, sz, sx, rrow, gain, g.nt,
                     g.dt * (1.0 / g.dx))
    cols = torch.as_tensor(rcv_x, device=vp.device).long() + g.pml_width
    idx = cols[:, None, :].expand(-1, g.nt, -1)
    return torch.gather(hx, 2, idx), torch.gather(hz, 2, idx)


@torch.no_grad()
def elastic_forward_pallas_plain(vp, vs, rho, wavelet, src_z, src_x, rcv_z,
                                 rcv_x, cfg: ElasticConfig):
    """Plain PyTorch version of :func:`elastic_forward_pallas` (any
    device): the ring forward's scan without a free-surface row."""
    return _forward(_rows_open_top, vp, vs, rho, wavelet, src_z, src_x,
                    rcv_z, rcv_x, cfg)


@torch.no_grad()
def elastic_forward_pallas(vp, vs, rho, wavelet, src_z, src_x, rcv_z, rcv_x,
                           cfg: ElasticConfig, *, route=None):
    """Forward elastic simulation with the contract of
    :func:`ops.elastic.simulate_elastic`: traces (vx, vz), each
    [ns, nt, nr].  A Kosloff sponge instead of the split-field PML, so
    amplitudes near the edges differ slightly from
    ``simulate_elastic``; receivers of a shot share row ``rcv_z[:, 0]``.
    Raises ``NotImplementedError`` on a free-surface grid.

    On a CUDA ``vp`` this runs the ring forward's kernels for all shots,
    on the route that ``scalar2.pick_route`` gives ``route`` with
    :func:`ops.elastic_fused.elastic_forward_plan` (by default the
    resident route where that plan holds the grid; "resident" raises
    where it does not); ``elastic_forward_pallas.launches`` counts the
    launches, ``resident_launches`` and ``per_step_launches`` each
    route's.  On a CPU ``vp`` it runs :func:`elastic_forward_pallas_plain`.  Any
    other device raises.
    """
    if not _kernel_route(vp, "elastic_forward_pallas"):
        return elastic_forward_pallas_plain(vp, vs, rho, wavelet, src_z,
                                            src_x, rcv_z, rcv_x, cfg)
    return _forward(partial(_rows_cuda, route=route), vp, vs, rho, wavelet,
                    src_z, src_x, rcv_z, rcv_x, cfg)


reset_launches(elastic_forward_pallas)
