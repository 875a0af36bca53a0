"""The second-order acoustic scheme in plain PyTorch, differentiable by
autograd (checkpointed chunk by chunk), and its trace-normalized L1
misfit.

Grid: the model edge-padded by ``pml`` cells on every side, then to a
multiple of 8 rows and 128 columns.  K = (vp dt / dx)^2; a Kosloff
sponge sigma = 0.5 (sigma_z + sigma_x), each the PML profile
sigma_max (d / L)^2 with sigma_max = 3 vmax ln(1e4) / (2 L), vmax 5000;
d+ = 1 / (1 + sigma dt / 2) times a two-cell zero ring, d- = 1 - sigma
dt / 2.  A step, for every shot at once:

    u1 = d+ (2 u0 - d- u_-1 + K Lap(u0)),   u1[src] += w_t K[src]

with Lap the 4th-order 5-point-per-axis Laplacian in grid units (zeros
outside the array); the receivers record u1 on their row.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fwibench.reference import scan

L0, L1, L2 = -5.0 / 2.0, 4.0 / 3.0, -1.0 / 12.0
EPS = 1e-10


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def edge_pad(x, top, bottom, left, right):
    nz, nx = x.shape[-2:]
    rows = torch.arange(-top, nz + bottom, device=x.device).clamp(0, nz - 1)
    cols = torch.arange(-left, nx + right, device=x.device).clamp(0, nx - 1)
    return x[..., rows, :][..., cols]


def sigma(n: int, lo: int, hi: int, dx: float, vmax: float, device):
    """The PML profile of length ``n`` with ``lo``/``hi`` absorbing cells
    (power 2, reflection 1e-4)."""
    x = torch.arange(n, dtype=torch.float32, device=device)
    s = torch.zeros(n, dtype=torch.float32, device=device)
    for w, d in ((lo, lambda L: torch.clamp((lo - x) * dx, 0.0, L)),
                 (hi, lambda L: torch.clamp((x - (n - 1 - hi)) * dx, 0.0, L))):
        if w > 0:
            L = w * dx
            smax = -3.0 * vmax * math.log(1e-4) / (2.0 * L)
            s = s + smax * (d(L) / L) ** 2
    return s


def coefficients(vp, g: dict):
    """(K, d+, d-) on the padded grid; K differentiable in ``vp``."""
    w = g["pml"]
    dev = vp.device
    vp_pad = edge_pad(vp, w, w, w, w)
    nzp, nxp = vp_pad.shape
    nz8, nx128 = round_up(nzp, 8), round_up(nxp, 128)
    K = edge_pad((vp_pad * g["dt"] / g["dx"]) ** 2, 0, nz8 - nzp, 0,
                 nx128 - nxp)
    sx = sigma(nxp, w, w, g["dx"], g["vmax_pml"], dev) * 0.5
    sz = sigma(nzp, w, w, g["dx"], g["vmax_pml"], dev) * 0.5
    sig = edge_pad(sz[:, None] + sx[None, :], 0, nz8 - nzp, 0, nx128 - nxp)
    ring = torch.zeros((nz8, nx128), dtype=torch.float32, device=dev)
    ring[2: nzp - 2, 2: nxp - 2] = 1.0
    dp = 1.0 / (1.0 + 0.5 * g["dt"] * sig) * ring
    dm = 1.0 - 0.5 * g["dt"] * sig
    return K, dp, dm


def lap(f):
    nz, nx = f.shape[-2:]
    p = F.pad(f, (2, 2, 2, 2))

    def at(di, dj):
        return p[..., 2 + di: 2 + di + nz, 2 + dj: 2 + dj + nx]

    return (2.0 * L0 * f
            + L1 * (at(0, 1) + at(0, -1) + at(1, 0) + at(-1, 0))
            + L2 * (at(0, 2) + at(0, -2) + at(2, 0) + at(-2, 0)))


def _step(state, params, amp_t):
    u0, um1 = state
    K, dp, dm, src, rcv = params
    ns = u0.shape[0]
    u1 = dp * (2.0 * u0 - dm * um1 + K * lap(u0))
    u1 = u1.reshape(ns, -1).scatter_add(1, src, amp_t[:, None]).reshape(
        u0.shape)
    return [u1, u0], u1.reshape(ns, -1).gather(1, rcv)


SCAN = scan.Scan(_step)


def simulate(vp, wavelet, geom: dict, g: dict):
    """Receiver traces [ns, nt, nr] of ``vp`` [nz, nx]; differentiable in
    ``vp`` when autograd records."""
    w = g["pml"]
    dev = vp.device
    K, dp, dm = coefficients(vp, g)
    nx128 = K.shape[1]
    sz = torch.as_tensor(geom["src_z"], device=dev) + w
    sx = torch.as_tensor(geom["src_x"], device=dev) + w
    src = (sz * nx128 + sx)[:, None]
    rrow = torch.as_tensor(geom["rcv_z"][:, :1], device=dev) + w
    rcv = rrow * nx128 + torch.as_tensor(geom["rcv_x"], device=dev) + w
    ns = src.shape[0]
    amp = wavelet.to(dev).expand(ns, -1) * K.reshape(-1)[src]
    state = [torch.zeros((ns,) + K.shape, dtype=K.dtype, device=dev)
             for _ in range(2)]
    return scan.run(SCAN, state, [K, dp, dm, src, rcv], amp)


def trace_normalize(d):
    """Each trace [ns, nt, nr] over its max |amplitude| in time."""
    return d / (torch.amax(torch.abs(d), dim=1, keepdim=True) + EPS)


def l1_misfit(pred, direct, obs_norm):
    """The trace-normalized L1 misfit of ``pred`` less the direct wave,
    summed and divided by ns nt nr."""
    y = trace_normalize(pred - direct)
    return torch.sum(torch.abs(y - obs_norm)) / obs_norm.numel()
