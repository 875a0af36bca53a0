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

Forward only, as every caller uses it: no gradient flows through the
exchange.
"""

from __future__ import annotations

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.ops import stencil
from physicsbasedfwi2_tpu_torch.ops.acoustic import (
    AcousticConfig, _damping, _pad_model, edge_pad,
)
from physicsbasedfwi2_tpu_torch.parallel.mesh import (
    Mesh, all_gather, exchange,
)

HALO = 2  # the 4th-order staggered stencils reach 2 cells


def _dx_dd(diff, f, inv_dx, mesh, axis):
    """``diff`` (a stencil's x derivative) of the slab ``f`` with the
    neighbours' edge strips as halos."""
    from_prev, from_next = exchange(f[:, :HALO], f[:, -HALO:], mesh, axis)
    fw = torch.cat([from_prev, f, from_next], dim=1)
    return diff(fw, inv_dx)[:, HALO:-HALO]


@torch.no_grad()
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
    time loop."""
    rz = np.asarray(torch.as_tensor(rcv_z).cpu())
    if not (rz == rz[:, :1]).all():
        raise ValueError(
            "simulate_acoustic_dd records a single receiver-depth row "
            "per shot; rcv_z must be constant within each shot "
            "(varying-depth geometries would silently return traces "
            "from the wrong cells)")
    g = cfg.grid
    dev = vp.device
    vp_pad = _pad_model(vp.to(torch.float32), g)
    kappa_dt = vp_pad * vp_pad * g.dt
    ax_v, az_v, ax_p, az_p = _damping(cfg, dev)
    nzp, nxp = vp_pad.shape
    n = mesh.shape[axis]
    if nxp % n:
        pad = n - nxp % n
        kappa_dt = edge_pad(kappa_dt, 0, 0, 0, pad)
        ax_v, ax_p = (edge_pad(a, 0, 0, 0, pad) for a in (ax_v, ax_p))
        nxp += pad
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
