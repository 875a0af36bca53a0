"""The 5-field elastic velocity-stress scheme with a free surface in plain
PyTorch, differentiable by autograd (checkpointed chunk by chunk), and
its trace-normalized L1 misfit on vx and vz.

Grid: (vp, vs, rho) edge-padded by 2 rows on top (the free surface's
ring) and ``pml`` cells on the other sides, then to a multiple of 8
rows and 128 columns.  Media: mu = rho vs^2, lam = rho (vp^2 - 2 vs^2),
l2m = lam + 2 mu; buoyancies bx, bz the means of 1/rho with the next
cell along x and z (circularly); mu_xz the harmonic mean of the four
cells at (i + 1/2, j + 1/2), 0 where any is fluid (mu <= 1e-3).  Sponge
decay exp(-0.5 (sigma_z + sigma_x) dt), no absorbing layer on top, zero
on a two-cell ring.  With dtx = dt / dx and D{x,z}{f,b} the 4th-order
staggered differences (9/8, -1/24) in grid units:

    vx' = damp (vx + dtx bx (Dxf sxx + Dzb sxz))
    vz' = damp (vz + dtx bz (Dxb sxz + Dzf szz))
    sxx' = damp (sxx + dtx (l2m Dxb vx' + lam Dzb vz')) + s_t
    szz' = fs damp (szz + dtx (lam Dxb vx' + l2m Dzb vz')) + fs s_t
    sxz' = damp (sxz + dtx mu_xz (Dxf vz' + Dzf vx'))

with s_t = w_t dt / dx^2 l2m[src] at the source cell and fs 0 on the
free-surface row, 1 elsewhere.  Receivers record vx' and vz' on their row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fwibench.reference import scan
from fwibench.reference.acoustic import EPS, edge_pad, round_up, sigma

C1, C2 = 9.0 / 8.0, -1.0 / 24.0
RING = 2


def layout(g: dict):
    w = g["pml"]
    nzp, nxp = g["nz"] + RING + w, g["nx"] + 2 * w
    return RING, w, nzp, nxp, round_up(nzp, 8), round_up(nxp, 128)


def media(vp, vs, rho, g: dict):
    """(lam, l2m, mu_xz, bx, bz) on the padded grid, differentiable."""
    top, w, nzp, nxp, nz8, nx128 = layout(g)
    vp, vs, rho = (edge_pad(a, top, w, w, w) for a in (vp, vs, rho))
    mu = rho * vs * vs
    lam = rho * (vp * vp - 2.0 * vs * vs)
    b = 1.0 / rho
    bx = 0.5 * (b + torch.roll(b, -1, dims=-1))
    bz = 0.5 * (b + torch.roll(b, -1, dims=-2))
    m2 = torch.roll(mu, -1, dims=-2)
    m3 = torch.roll(mu, -1, dims=-1)
    m4 = torch.roll(m2, -1, dims=-1)
    solid = torch.minimum(torch.minimum(mu, m2), torch.minimum(m3, m4)) > 1e-3
    one = torch.ones_like(mu)
    inv = sum(1.0 / torch.where(solid, m, one) for m in (mu, m2, m3, m4))
    muxz = torch.where(solid, 4.0 / inv, torch.zeros_like(mu))
    return tuple(edge_pad(m, 0, nz8 - nzp, 0, nx128 - nxp)
                 for m in (lam, lam + 2.0 * mu, muxz, bx, bz))


def damping(g: dict, device):
    top, w, nzp, nxp, nz8, nx128 = layout(g)
    sx = sigma(nxp, w, w, g["dx"], g["vmax_pml"], device) * 0.5
    sz = sigma(nzp, 0, w, g["dx"], g["vmax_pml"], device) * 0.5
    full = torch.zeros((nz8, nx128), dtype=torch.float32, device=device)
    full[RING: nzp - RING, RING: nxp - RING] = torch.exp(
        -(sz[:, None] + sx[None, :]) * g["dt"])[RING: nzp - RING,
                                                RING: nxp - RING]
    return full


def _sh(f, k, axis):
    """out[i] = f[i + k] along ``axis`` (-1 or -2), zeros outside."""
    n = f.shape[axis]
    pad = [0, 0, 0, 0]
    lo = 0 if axis == -1 else 2
    if k > 0:
        pad[lo + 1] = k
        return F.pad(f, pad).narrow(axis, k, n)
    pad[lo] = -k
    return F.pad(f, pad).narrow(axis, 0, n)


def _df(f, axis):
    return C1 * (_sh(f, 1, axis) - f) + C2 * (_sh(f, 2, axis) - _sh(f, -1, axis))


def _db(f, axis):
    return C1 * (f - _sh(f, -1, axis)) + C2 * (_sh(f, 1, axis) - _sh(f, -2, axis))


def _step(state, params, amp_t):
    vx, vz, sxx, szz, sxz = state
    lam, l2m, muxz, bx, bz, damp, fs, dtx, src, rcv = params
    ns = vx.shape[0]

    def add_src(f):
        return f.reshape(ns, -1).scatter_add(1, src, amp_t[:, None]).reshape(
            f.shape)

    vx = damp * (vx + dtx * bx * (_df(sxx, -1) + _db(sxz, -2)))
    vz = damp * (vz + dtx * bz * (_db(sxz, -1) + _df(szz, -2)))
    a, b = _db(vx, -1), _db(vz, -2)
    sxx = add_src(damp * (sxx + dtx * (l2m * a + lam * b)))
    szz = add_src(damp * (szz + dtx * (lam * a + l2m * b))) * fs
    sxz = damp * (sxz + dtx * muxz * (_df(vz, -1) + _df(vx, -2)))
    rec = torch.cat([vx.reshape(ns, -1).gather(1, rcv),
                     vz.reshape(ns, -1).gather(1, rcv)], 1)
    return [vx, vz, sxx, szz, sxz], rec


SCAN = scan.Scan(_step)


def simulate(vp, vs, rho, wavelet, geom: dict, g: dict, *,
             gain_grad: bool = True):
    """Receiver traces (vx, vz), each [ns, nt, nr], of the model;
    differentiable in (vp, vs, rho) when autograd records.  With
    ``gain_grad=False`` the source gain l2m[src] is held constant in the
    gradient (the fused loss-and-gradient's convention)."""
    top, w = RING, g["pml"]
    dev = vp.device
    meds = media(vp, vs, rho, g)
    damp = damping(g, dev)
    nx128 = damp.shape[1]
    fs = torch.ones((damp.shape[0], 1), dtype=damp.dtype, device=dev)
    fs[top] = 0.0
    sz = torch.as_tensor(geom["src_z"], device=dev) + top
    sx = torch.as_tensor(geom["src_x"], device=dev) + w
    src = (sz * nx128 + sx)[:, None]
    rrow = torch.as_tensor(geom["rcv_z"][:, :1], device=dev) + top
    rcv = rrow * nx128 + torch.as_tensor(geom["rcv_x"], device=dev) + w
    ns, nr = rcv.shape
    l2m_src = meds[1].reshape(-1)[src[:, 0]]
    if not gain_grad:
        l2m_src = l2m_src.detach()
    amp = (wavelet.to(dev).expand(ns, -1)
           * (g["dt"] / (g["dx"] * g["dx"]) * l2m_src)[:, None])
    state = [torch.zeros((ns,) + damp.shape, dtype=damp.dtype, device=dev)
             for _ in range(5)]
    dtx = torch.tensor(g["dt"] / g["dx"], device=dev)
    recs = scan.run(SCAN, state, [*meds, damp, fs, dtx, src, rcv], amp)
    return recs[..., :nr], recs[..., nr:]


def trace_normalize(d):
    return d / (torch.amax(torch.abs(d), dim=1, keepdim=True) + EPS)


def tnl1_misfit(px, pz, ox_norm, oz_norm):
    """The trace-normalized L1 misfit of both components against the
    normalized observed traces, summed and divided by ns nt nr."""
    return ((torch.sum(torch.abs(trace_normalize(px) - ox_norm))
             + torch.sum(torch.abs(trace_normalize(pz) - oz_norm)))
            / ox_norm.numel())


def lowpass(x, fc: float, dt: float, axis: int, order: int = 6):
    """Zero-phase order-6 Butterworth low-pass along ``axis`` (FFT)."""
    if not fc or fc <= 0:
        return x
    nt = x.shape[axis]
    f = torch.fft.rfftfreq(nt, dt, dtype=torch.float32, device=x.device)
    h = (1.0 / torch.sqrt(1.0 + (f / fc) ** (2 * order))).to(x.dtype)
    shape = [1] * x.ndim
    shape[axis] = h.shape[0]
    spec = torch.fft.rfft(x, dim=axis) * h.reshape(shape)
    return torch.fft.irfft(spec, n=nt, dim=axis).to(x.dtype)
