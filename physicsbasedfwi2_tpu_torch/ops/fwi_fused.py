"""Fused FWI loss+gradient (kernel B2).

Port of ``physicsbasedfwi2_tpu/ops/pallas_fwi_fused.py``
(``fwi_l1_loss_grad``, ``scatter_rows``; Pallas kernel ``_kernel``).
One call computes, for every shot:

1. the forward sweep of the second-order scheme (as in
   :mod:`scalar2`) with checkpoints (u0, u_m1) every KC steps and the
   receiver-row history y = pred - direct,
2. the trace-normalized L1 misfit and its exact VJP, including the
   tie-distributed subgradient of the per-trace max (jnp.max's):

       loss = inv_count * sum_{t,c} |y_tc/(m_c+eps) - obs_tc| * mask_c
       g    = sign(yn - obs) * mask * inv_count
       ybar = g/(m+eps) - 1[|y| == m] sign(y)/(m+eps) * S / cnt,
       S    = sum_t g yn,  cnt = #ties

3. the reverse sweep: restore each chunk from its checkpoint, recompute
   it caching Lap(u0), and run the exact transpose, accumulating dJ/dK.

Then the host-side chain rule K = (vp dt/dx)^2 and the transpose of the
edge padding give dJ/dvp.

:func:`fwi_l1_loss_grad` launches the hand-written CUDA kernel
(``csrc/scalar2.cu::b2_fwi_l1_loss_grad``) on CUDA tensors and runs
:func:`fwi_l1_loss_grad_plain`, the same algorithm in plain PyTorch
batched over shots, on CPU tensors.
"""

from __future__ import annotations

import torch

from physicsbasedfwi2_tpu_torch.ops.acoustic import AcousticConfig, _pad_model
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    _common, _lap, _round_up, _step,
)

EPS = 1e-10


def _misfit_plain(hist, obs_rows, rmask, inv_count):
    """(loss, ybar) of the trace-normalized L1 misfit over row
    histories [ns, nt_pad, nx], with its hand-derived VJP (the exact
    jnp.max subgradient: each tied maximum carries its own sign / cnt;
    sign(0) = 0)."""
    m = torch.amax(torch.abs(hist), dim=1, keepdim=True)
    inv_m = 1.0 / (m + EPS)
    star = (torch.abs(hist) == m).to(hist.dtype)
    inv_cnt = 1.0 / torch.clamp(star.sum(dim=1, keepdim=True), min=1.0)
    yn = hist * inv_m
    r = (yn - obs_rows) * rmask[:, None, :]
    g = torch.sign(r) * inv_count
    loss = torch.sum(torch.abs(r)) * inv_count
    S = torch.sum(g * yn, dim=1, keepdim=True)
    corr = inv_cnt * S * inv_m
    return loss, g * inv_m - star * torch.sign(hist) * corr


def _loss_gk_plain(K, dp, dm, wav, sz, sx, rrow, obs_rows, dir_rows, rmask,
                   nt, KC, inv_count):
    """(loss, dJ/dK on the padded grid) in plain PyTorch."""
    ns, nt_pad = wav.shape
    n_ck = nt_pad // KC
    nz8, nx128 = K.shape
    dev = K.device
    shot = torch.arange(ns, device=dev)
    sz, sx, rrow = sz.long(), sx.long(), rrow.long()
    gain = K[sz, sx]

    # phase 1: forward sweep, checkpoints, hist rows = pred - direct
    u0 = torch.zeros((ns, nz8, nx128), dtype=K.dtype, device=dev)
    um1 = torch.zeros_like(u0)
    ckpt = torch.empty((ns, n_ck, 2, nz8, nx128), dtype=K.dtype, device=dev)
    hist = torch.zeros((ns, nt_pad, nx128), dtype=K.dtype, device=dev)
    for c in range(n_ck):
        ckpt[:, c, 0] = u0
        ckpt[:, c, 1] = um1
        for kk in range(KC):
            t = c * KC + kk
            u1 = _step(u0, um1, K, dp, dm, _lap(u0), shot, sz, sx, gain,
                       wav[:, t])
            um1, u0 = u0, u1
            if t < nt:
                hist[:, t] = u0[shot, rrow] - dir_rows[:, t]

    # phase 2: misfit and the cotangent rows
    loss, ybar = _misfit_plain(hist, obs_rows, rmask, inv_count)

    # phase 3: reverse sweep from the checkpoints (exact transpose)
    pb = torch.zeros_like(u0)
    qb = torch.zeros_like(u0)
    gk = torch.zeros_like(u0)
    lapc = torch.empty((ns, KC, nz8, nx128), dtype=K.dtype, device=dev)
    for c in reversed(range(n_ck)):
        u0 = ckpt[:, c, 0]
        um1 = ckpt[:, c, 1]
        for kk in range(KC):
            t = c * KC + kk
            lapc[:, kk] = _lap(u0)
            u1 = _step(u0, um1, K, dp, dm, lapc[:, kk], shot, sz, sx, gain,
                       wav[:, t])
            um1, u0 = u0, u1
        for kk in reversed(range(KC)):
            t = c * KC + kk
            if t < nt:
                pb[shot, rrow] += ybar[:, t]
            w = dp * pb
            # the source is added after the damping: its cotangent is pb
            gk[shot, sz, sx] += wav[:, t] * pb[shot, sz, sx]
            gk = gk + w * lapc[:, kk]
            pb, qb = qb + 2.0 * w + _lap(K * w), -(dm * w)
    gk_sum = gk[0]
    for s in range(1, ns):
        gk_sum = gk_sum + gk[s]
    return loss, gk_sum


def _loss_gk_cuda(K, dp, dm, wav, sz, sx, rrow, obs_rows, dir_rows, rmask,
                  nt, KC, inv_count):
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    ns, nt_pad = wav.shape
    n_ck = nt_pad // KC
    nz8, nx128 = K.shape
    dev = K.device
    f32, i32 = torch.float32, torch.int32
    for name, a, dtype, shape in (
            ("K", K, f32, (nz8, nx128)), ("d+", dp, f32, (nz8, nx128)),
            ("d-", dm, f32, (nz8, nx128)), ("wavelet", wav, f32, None),
            ("src_z", sz, i32, (ns,)), ("src_x", sx, i32, (ns,)),
            ("rcv_row", rrow, i32, (ns,)),
            ("obs_rows", obs_rows, f32, (ns, nt_pad, nx128)),
            ("dir_rows", dir_rows, f32, (ns, nt_pad, nx128)),
            ("rmask", rmask, f32, (ns, nx128))):
        if a.device != dev or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(f"fwi_l1_loss_grad: {name} must be a "
                             f"contiguous {dtype} tensor on {dev}")
        if shape is not None and tuple(a.shape) != shape:
            raise ValueError(f"fwi_l1_loss_grad: {name} has shape "
                             f"{tuple(a.shape)}, expected {shape}")
    if n_ck * KC != nt_pad or nt_pad < nt:
        raise ValueError("fwi_l1_loss_grad: wavelet must be padded to "
                         "a multiple of KC >= nt")
    lib = cuda_build.load_library()

    def field(*lead):
        return torch.empty(lead + (nz8, nx128), dtype=f32, device=dev)

    u0, um1, pb0, pb1, qb, gk_shots = (field(ns) for _ in range(6))
    lapc = field(ns, KC)
    ckpt = field(ns, n_ck, 2)
    hist = torch.empty((ns, nt_pad, nx128), dtype=f32, device=dev)
    loss_part = torch.empty((ns, nx128), dtype=torch.float64, device=dev)
    loss = torch.empty((), dtype=f32, device=dev)
    gk = torch.empty((nz8, nx128), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() for a in (
        K, dp, dm, wav, sz, sx, rrow, obs_rows, dir_rows, rmask, u0, um1,
        pb0, pb1, qb, gk_shots, lapc, hist, ckpt, loss_part, loss, gk)]
    err = lib.b2_fwi_l1_loss_grad(*ptrs, ns, nz8, nx128, nt, n_ck, KC,
                                  inv_count, stream)
    cuda_build.check(err, "b2_fwi_l1_loss_grad")
    fwi_l1_loss_grad.launches += 1
    return loss, gk


def _loss_grad(core, vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
               obs_rows, dir_rows, KC, want_wavelet_grad,
               dtype=torch.float32):
    if want_wavelet_grad:
        raise NotImplementedError(
            "want_wavelet_grad (marmousi_acoustic_wav) is not ported yet: "
            "ROADMAP Queue A, slice-1 leftovers")
    g = cfg.grid
    dev = vp.device
    ns = int(src_z.shape[0])
    nr = int(rcv_x.shape[1])
    n_ck = -(-g.nt // KC)
    nt_pad = n_ck * KC
    (K, dp, dm, _, nx128, wav, sz, sx,
     rrow) = _common(vp, wavelet, src_z, src_x, rcv_z, cfg)
    wav = torch.nn.functional.pad(wav, (0, nt_pad - g.nt)).contiguous()
    cols = torch.as_tensor(rcv_x, device=dev).long() + g.pml_width
    rmask = torch.zeros((ns, nx128), dtype=torch.float32, device=dev)
    rmask.scatter_(1, cols, 1.0)
    inv_count = 1.0 / float(ns * g.nt * nr)
    if dtype != torch.float32:
        K, dp, dm, wav, obs_rows, dir_rows, rmask = (
            a.to(dtype) for a in (K, dp, dm, wav, obs_rows, dir_rows, rmask))
    loss, gk = core(K, dp, dm, wav, sz, sx, rrow, obs_rows, dir_rows, rmask,
                    g.nt, KC, inv_count)
    return loss, _vp_grad(gk, vp, cfg)


def _vp_grad(gk: torch.Tensor, vp: torch.Tensor, cfg: AcousticConfig):
    """Chain rule K = (vp dt/dx)^2, then the transpose of the edge
    padding (pad-region gradient folds onto the edge rows/columns)."""
    g = cfg.grid
    top, w = g.top_pad, g.pml_width
    vp_pad = _pad_model(vp.to(torch.float32), g).to(gk.dtype)
    nzp, nxp = vp_pad.shape
    gz = gk[:nzp, :nxp] * (2.0 * vp_pad * (g.dt / g.dx) ** 2)
    row_bot = torch.sum(gz[top + g.nz:, :], dim=0)
    row_top = torch.sum(gz[:top, :], dim=0) if top else None
    gz = gz[top: top + g.nz, :].clone()
    if row_top is not None:
        gz[0, :] += row_top
    gz[-1, :] += row_bot
    col_l = torch.sum(gz[:, :w], dim=1)
    col_r = torch.sum(gz[:, w + g.nx:], dim=1)
    gz = gz[:, w: w + g.nx].clone()
    gz[:, 0] += col_l
    gz[:, -1] += col_r
    return gz


@torch.no_grad()
def fwi_l1_loss_grad_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                           cfg: AcousticConfig, obs_rows, dir_rows,
                           *, KC: int = 32, want_wavelet_grad: bool = False,
                           dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`fwi_l1_loss_grad` (any device).
    The coefficients and rows enter in float32, as the kernel gets them;
    ``dtype=torch.float64`` then runs the same discrete problem without
    float32 rounding (a reference for the kernel's error)."""
    return _loss_grad(_loss_gk_plain, vp, wavelet, src_z, src_x, rcv_z,
                      rcv_x, cfg, obs_rows, dir_rows, KC, want_wavelet_grad,
                      dtype)


@torch.no_grad()
def fwi_l1_loss_grad(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                     cfg: AcousticConfig, obs_rows, dir_rows,
                     *, KC: int = 32, want_wavelet_grad: bool = False):
    """(loss, dJ/dvp) for the trace-normalized L1 misfit with
    direct-wave removal.

    Args:
        obs_rows: [ns, nt_pad, nx128] trace-normalized observed data
            scattered into receiver-row columns (:func:`scatter_rows`).
        dir_rows: [ns, nt_pad, nx128] direct-wave rows, same layout.
        want_wavelet_grad: not ported yet (raises).

    On a CUDA ``vp`` this launches kernel B2
    (``fwi_l1_loss_grad.launches`` counts the launches); on a CPU
    ``vp`` it runs :func:`fwi_l1_loss_grad_plain`.  Any other device
    raises.
    """
    if vp.device.type == "cpu":
        return fwi_l1_loss_grad_plain(
            vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg, obs_rows,
            dir_rows, KC=KC, want_wavelet_grad=want_wavelet_grad)
    if vp.device.type != "cuda":
        raise ValueError(f"fwi_l1_loss_grad: no kernel for device "
                         f"{vp.device}")
    return _loss_grad(_loss_gk_cuda, vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                      cfg, obs_rows, dir_rows, KC, want_wavelet_grad)


fwi_l1_loss_grad.launches = 0


def scatter_rows(data, rcv_x, *, nt, nx, pml_width, KC: int = 32):
    """[ns, nt, nr] traces -> [ns, nt_pad, nx128] receiver-row layout
    used by the fused kernel (duplicate columns add)."""
    ns, _, nr = data.shape
    nt_pad = -(-nt // KC) * KC
    nx128 = _round_up(nx + 2 * pml_width, 128)
    cols = torch.as_tensor(rcv_x, device=data.device).long() + pml_width
    rows = torch.zeros((ns, nt_pad, nx128), dtype=torch.float32,
                       device=data.device)
    rows[:, :nt].scatter_add_(2, cols[:, None, :].expand(ns, nt, nr),
                              data.to(torch.float32))
    return rows
