"""Second-order scalar wave equation, forward (kernel B1).

Port of ``physicsbasedfwi2_tpu/ops/pallas_scalar2.py`` (``_prepare2``,
``forward2``; Pallas kernel ``_fwd_kernel``).  Scheme (K = vp^2 dt^2 /
dx^2, sigma = Kosloff sponge profile, d+ = 1/(1+sigma dt/2), d- =
1-sigma dt/2, a 2-cell zero ring folded into d+):

    u1 = d+ * (2 u0 - d- u_m1 + K Lap(u0)) + e_src * amp * K[src]
    y_t = u1[rrow]

:func:`forward2` launches the hand-written CUDA kernel
(``csrc/scalar2.cu::b1_forward2``) on CUDA tensors and runs
:func:`forward2_plain`, the same algorithm in plain PyTorch batched
over shots, on CPU tensors.  Fields read zeros outside the array where
Pallas rolls circularly; the zero ring makes the two equal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from physicsbasedfwi2_tpu_torch.ops import pml
from physicsbasedfwi2_tpu_torch.ops.acoustic import (
    AcousticConfig, _pad_model, edge_pad,
)

# 4th-order Laplacian coefficients (per axis): [-1/12, 4/3, -5/2, 4/3, -1/12]
_L1 = 4.0 / 3.0
_L2 = -1.0 / 12.0
_L0 = -5.0 / 2.0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _lap(f: torch.Tensor) -> torch.Tensor:
    """4th-order 5-point-per-axis Laplacian of [..., nz, nx] in grid
    units, reading zeros outside the array; summed in the order of the
    Pallas ``_lap``."""
    nz, nx = f.shape[-2:]
    p = F.pad(f, (2, 2, 2, 2))

    def at(di, dj):
        return p[..., 2 + di: 2 + di + nz, 2 + dj: 2 + dj + nx]

    return (2.0 * _L0 * f
            + _L1 * (at(0, 1) + at(0, -1) + at(1, 0) + at(-1, 0))
            + _L2 * (at(0, 2) + at(0, -2) + at(2, 0) + at(-2, 0)))


def _prepare2(vp: torch.Tensor, cfg: AcousticConfig):
    """K, d+, d- on the [nz8, nx128] padded grid (on vp's device)."""
    g = cfg.grid
    dev = vp.device
    vp_pad = _pad_model(vp.to(torch.float32), g)
    nzp, nxp = vp_pad.shape
    nz8 = _round_up(nzp, 8)
    nx128 = _round_up(nxp, 128)
    K = (vp_pad * g.dt / g.dx) ** 2
    K = edge_pad(K, 0, nz8 - nzp, 0, nx128 - nxp)
    # sponge profile: sigma_x + sigma_z (Kosloff absorber), scaled
    # down vs the PML formula (sponges over-reflect if too strong)
    top = 0 if g.free_surface else g.pml_width
    w = g.pml_width
    sx = pml.sigma_profile(nxp, w, w, g.dx, cfg.vmax_pml, device=dev) * 0.5
    sz = pml.sigma_profile(nzp, top, w, g.dx, cfg.vmax_pml, device=dev) * 0.5
    sig = sz[:, None] + sx[None, :]
    sig = edge_pad(sig, 0, nz8 - nzp, 0, nx128 - nxp)
    d_plus = 1.0 / (1.0 + 0.5 * g.dt * sig)
    d_minus = 1.0 - 0.5 * g.dt * sig
    # zero ring (2 cells): every field stays 0 near the array edge
    rows = torch.zeros((nz8, 1), dtype=torch.float32, device=dev)
    rows[2: nzp - 2] = 1.0
    cols = torch.zeros((1, nx128), dtype=torch.float32, device=dev)
    cols[0, 2: nxp - 2] = 1.0
    d_plus = d_plus * (rows * cols)
    return K, d_plus, d_minus, (nz8, nx128)


def _common(vp, wavelet, src_z, src_x, rcv_z, cfg):
    """Coefficients, per-shot wavelet [ns, nt] and padded int32 geometry
    on vp's device."""
    g = cfg.grid
    dev = vp.device
    ns = int(src_z.shape[0])
    K, dp, dm, (nz8, nx128) = _prepare2(vp, cfg)
    top, w = g.top_pad, g.pml_width
    wavelet = torch.as_tensor(wavelet, device=dev).to(torch.float32)
    if wavelet.ndim == 1:
        wavelet = wavelet[None, :].expand(ns, g.nt)
    wav = wavelet.contiguous()

    def idx(a, off):
        return (torch.as_tensor(a, device=dev).to(torch.int32)
                + off).contiguous()

    src_z_p = idx(src_z, top)
    src_x_p = idx(src_x, w)
    rcv_row = idx(torch.as_tensor(rcv_z)[:, 0], top)
    return K, dp, dm, nz8, nx128, wav, src_z_p, src_x_p, rcv_row


def _step(u0, um1, K, dp, dm, lapv, shot, sz, sx, gain, amp):
    """One step of the scheme for all shots; source added after the
    damping, with gain K[src]."""
    u1 = dp * (2.0 * u0 - dm * um1 + K * lapv)
    u1[shot, sz, sx] += amp * gain
    return u1


def _rows_plain(K, dp, dm, wav, sz, sx, rrow, nt):
    ns = wav.shape[0]
    nz8, nx128 = K.shape
    shot = torch.arange(ns, device=K.device)
    sz, sx, rrow = sz.long(), sx.long(), rrow.long()
    gain = K[sz, sx]
    u0 = torch.zeros((ns, nz8, nx128), dtype=K.dtype, device=K.device)
    um1 = torch.zeros_like(u0)
    hist = torch.empty((ns, nt, nx128), dtype=K.dtype, device=K.device)
    for t in range(nt):
        u1 = _step(u0, um1, K, dp, dm, _lap(u0), shot, sz, sx, gain,
                   wav[:, t])
        um1, u0 = u0, u1
        hist[:, t] = u0[shot, rrow]
    return hist


def _rows_cuda(K, dp, dm, wav, sz, sx, rrow, nt):
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    ns = wav.shape[0]
    nz8, nx128 = K.shape
    dev = K.device
    for name, a, dtype in (("K", K, torch.float32), ("d+", dp, torch.float32),
                           ("d-", dm, torch.float32),
                           ("wavelet", wav, torch.float32),
                           ("src_z", sz, torch.int32),
                           ("src_x", sx, torch.int32),
                           ("rcv_row", rrow, torch.int32)):
        if a.device != dev or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(f"forward2: {name} must be a contiguous "
                             f"{dtype} tensor on {dev}")
    if dp.shape != K.shape or dm.shape != K.shape or wav.shape != (ns, nt):
        raise ValueError("forward2: coefficient or wavelet shape mismatch")
    if sz.shape != (ns,) or sx.shape != (ns,) or rrow.shape != (ns,):
        raise ValueError("forward2: geometry must be [ns] per shot")
    lib = cuda_build.load_library()
    u0 = torch.empty((ns, nz8, nx128), dtype=torch.float32, device=dev)
    um1 = torch.empty_like(u0)
    hist = torch.zeros((ns, nt, nx128), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.b1_forward2(K.data_ptr(), dp.data_ptr(), dm.data_ptr(),
                          wav.data_ptr(), sz.data_ptr(), sx.data_ptr(),
                          rrow.data_ptr(), u0.data_ptr(), um1.data_ptr(),
                          hist.data_ptr(), ns, nz8, nx128, nt, stream)
    cuda_build.check(err, "b1_forward2")
    forward2.launches += 1
    return hist


def _forward2(rows_fn, vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
              return_rows, dtype=torch.float32):
    g = cfg.grid
    (K, dp, dm, _, _, wav, sz, sx,
     rrow) = _common(vp, wavelet, src_z, src_x, rcv_z, cfg)
    K, dp, dm, wav = (a.to(dtype) for a in (K, dp, dm, wav))
    hist = rows_fn(K, dp, dm, wav, sz, sx, rrow, g.nt)
    if return_rows:
        return hist
    cols = torch.as_tensor(rcv_x, device=vp.device).long() + g.pml_width
    return torch.gather(hist, 2, cols[:, None, :].expand(-1, g.nt, -1))


@torch.no_grad()
def forward2_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                   cfg: AcousticConfig, *, return_rows: bool = False,
                   dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`forward2` (any device).  The
    coefficients are always prepared in float32, as the kernel gets
    them; ``dtype=torch.float64`` then runs the same discrete problem
    without float32 rounding (a reference for the kernel's error)."""
    return _forward2(_rows_plain, vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                     cfg, return_rows, dtype)


@torch.no_grad()
def forward2(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
             cfg: AcousticConfig, *, return_rows: bool = False):
    """Second-order-scheme forward: traces [ns, nt, nr], or with
    ``return_rows`` the full receiver-row history [ns, nt, nx128] (the
    layout the fused kernel's dir/obs rows use).

    On a CUDA ``vp`` this launches kernel B1 (``forward2.launches``
    counts the launches); on a CPU ``vp`` it runs
    :func:`forward2_plain`.  Any other device raises.
    """
    if vp.device.type == "cpu":
        return forward2_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
                              return_rows=return_rows)
    if vp.device.type != "cuda":
        raise ValueError(f"forward2: no kernel for device {vp.device}")
    return _forward2(_rows_cuda, vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                     cfg, return_rows)


forward2.launches = 0
