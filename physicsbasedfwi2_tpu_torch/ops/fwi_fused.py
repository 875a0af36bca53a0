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
   it caching Lap(u0), and run the exact transpose, accumulating dJ/dK
   and, with ``want_wavelet_grad``, dJ/d amp_t = K[src] pb[src] (the
   source is added after the damping, so its cotangent is pb there).

Then the host-side chain rule K = (vp dt/dx)^2 and the transpose of the
edge padding give dJ/dvp.

:func:`fwi_l1_loss_grad` launches the hand-written CUDA kernel
(``csrc/scalar2.cu``: ``b2_fwi_l1_loss_grad_resident``, one
thread-block cluster per shot, where the resident plan holds the grid,
else ``b2_fwi_l1_loss_grad``, a launch per step) on CUDA tensors and runs
:func:`fwi_l1_loss_grad_plain`, the same algorithm in plain PyTorch
batched over shots, on CPU tensors.
"""

from __future__ import annotations

from functools import partial

import torch

from physicsbasedfwi2_tpu_torch.ops.acoustic import AcousticConfig
# scatter_rows is re-exported: the JAX package's pallas_fwi_fused has it
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (  # noqa: F401
    _bwd_plain_shots, _common, _fwd_ckpt_plain, _sum_shots, _vp_grad,
    count_launch, pick_route, reset_launches, scatter_rows,
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
                   nt, KC, inv_count, want_gwav):
    """(loss, dJ/dK on the padded grid, dJ/dwavelet [ns, n_ck*KC] or
    None) in plain PyTorch: B4a's forward sweep, the misfit, B4b's
    reverse sweep."""
    hist, ckpt = _fwd_ckpt_plain(K, dp, dm, wav, sz, sx, rrow, nt, KC,
                                 dir_rows)
    loss, ybar = _misfit_plain(hist, obs_rows, rmask, inv_count)
    gk, gw = _bwd_plain_shots(K, dp, dm, wav, sz, sx, rrow, ybar, ckpt, nt)
    return loss, _sum_shots(gk), gw if want_gwav else None


def _loss_gk_cuda(K, dp, dm, wav, sz, sx, rrow, obs_rows, dir_rows, rmask,
                  nt, KC, inv_count, want_gwav, route=None):
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
    route, plan = pick_route("fwi_l1_loss_grad", nz8, nx128, route)

    def field(*lead):
        return torch.empty(lead + (nz8, nx128), dtype=f32, device=dev)

    hist = torch.empty((ns, nt_pad, nx128), dtype=f32, device=dev)
    loss_part = torch.empty((ns, nx128), dtype=torch.float64, device=dev)
    loss = torch.empty((), dtype=f32, device=dev)
    gk = torch.empty((nz8, nx128), dtype=f32, device=dev)
    gw = (torch.empty((ns, nt_pad), dtype=f32, device=dev) if want_gwav
          else None)
    gw_ptr = gw.data_ptr() if want_gwav else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() for a in (K, dp, dm, wav, sz, sx, rrow, obs_rows,
                                   dir_rows, rmask)]
    gk_shots, lapc, ckpt = field(ns), field(ns, KC), field(ns, n_ck, 2)
    if route == "resident":
        out = [gk_shots, lapc, hist, ckpt, loss_part, loss, gk]
        cuda_build.call(
            dev, "b2_fwi_l1_loss_grad_resident", *ptrs, *(a.data_ptr() for a in
            out), gw_ptr, ns, nz8, nx128, nt, n_ck, KC, *plan.args(),
            inv_count, stream)
    else:
        u0, um1, pb0, pb1, qb = (field(ns) for _ in range(5))
        out = [u0, um1, pb0, pb1, qb, gk_shots, lapc, hist, ckpt, loss_part,
               loss, gk]
        cuda_build.call(
            dev, "b2_fwi_l1_loss_grad", *ptrs, *(a.data_ptr() for a in out),
            gw_ptr, ns, nz8, nx128, nt, n_ck, KC, inv_count, stream)
    count_launch(fwi_l1_loss_grad, route)
    return loss, gk, gw


def _loss_grad(core, vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
               obs_rows, dir_rows, KC, want_wavelet_grad,
               dtype=torch.float32):
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
    loss, gk, gw = core(K, dp, dm, wav, sz, sx, rrow, obs_rows, dir_rows,
                        rmask, g.nt, KC, inv_count, want_wavelet_grad)
    gz = _vp_grad(gk, vp, cfg, (g.dt / g.dx) ** 2)
    if want_wavelet_grad:
        return loss, gz, gw[:, :g.nt]
    return loss, gz


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
                     *, KC: int = 32, want_wavelet_grad: bool = False,
                     route=None):
    """(loss, dJ/dvp[, dJ/dwavelet]) for the trace-normalized L1 misfit
    with direct-wave removal.

    Args:
        obs_rows: [ns, nt_pad, nx128] trace-normalized observed data
            scattered into receiver-row columns (:func:`scatter_rows`).
        dir_rows: [ns, nt_pad, nx128] direct-wave rows, same layout.
        want_wavelet_grad: also return dJ/dwavelet [ns, nt] (per shot,
            whether the wavelet was given as [nt] or [ns, nt]).

    On a CUDA ``vp`` this launches kernel B2 on the route that
    ``scalar2.pick_route`` gives ``route`` (by default the resident
    route where its plan holds the grid); ``fwi_l1_loss_grad.launches``
    counts the launches, ``resident_launches`` and ``per_step_launches``
    each route's.  On a CPU ``vp`` it runs
    :func:`fwi_l1_loss_grad_plain`.  Any other device raises.
    """
    if vp.device.type == "cpu":
        return fwi_l1_loss_grad_plain(
            vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg, obs_rows,
            dir_rows, KC=KC, want_wavelet_grad=want_wavelet_grad)
    if vp.device.type != "cuda":
        raise ValueError(f"fwi_l1_loss_grad: no kernel for device "
                         f"{vp.device}")
    return _loss_grad(partial(_loss_gk_cuda, route=route), vp, wavelet, src_z,
                      src_x, rcv_z, rcv_x, cfg, obs_rows, dir_rows, KC,
                      want_wavelet_grad)


reset_launches(fwi_l1_loss_grad)
