"""Exact transpose of kernel B5 (kernel B6) and the differentiable
propagator ``acoustic_pallas``.

Port of ``physicsbasedfwi2_tpu/ops/pallas_adjoint.py``
(``_pallas_backward``, ``acoustic_pallas``; Pallas kernel
``_bwd_kernel``).  With a = dt/dx, kap = vp^2 dt/dx and (avx, avz, apx,
apz) the cotangents, one step of :mod:`ops.kernels`' scheme transposes
to

    apx += S^T ybar_t;  apz += S^T ybar_t
    kbar[src] += (amp_t/dx) apz[src]
    wx = ax_p apx;  wz = az_p apz;  kbar += wx Dxb(vx1) + wz Dzb(vz1)
    vbx = avx - Dxf(kap wx);  vbz = avz - Dzf(kap wz)
    pb0 = -a (Dxb(ax_v vbx) + Dzb(az_v vbz))
    (avx, avz, apx, apz) <- (ax_v vbx, az_v vbz, wx + pb0, wz + pb0)

then dJ/dvp = kbar 2 vp dt/dx and the edge-pad transpose.

:func:`acoustic_pallas_backward` launches the hand-written CUDA kernel
(``csrc/acoustic.cu``) on CUDA tensors.  Like the Pallas kernel it runs
its own forward sweep, checkpointing the four fields every K = 16 steps
(``b6_checkpoints``), then per chunk recomputes K steps caching Dxb(vx),
Dzb(vz) and runs K adjoint steps (``b6_adjoint``);
``acoustic_pallas``'s forward saves only its inputs.  Both sweeps have
B5's two routes (the resident one wherever
:func:`kernels.acoustic_resident_plan` holds the grid: one launch a
sweep; the per-step one elsewhere), with the same arithmetic.  On CPU
tensors it runs :func:`acoustic_pallas_backward_plain`: autograd
through the plain forward under :func:`chunked_checkpoint_scan`, which
is the same exact transpose without a second hand-derived sweep.  On this package the
names mean the CUDA kernels.
"""

from __future__ import annotations

import torch

from physicsbasedfwi2_tpu_torch.ops.acoustic import AcousticConfig
from physicsbasedfwi2_tpu_torch.ops.kernels import (
    acoustic_forward_pallas, acoustic_resident_plan, check_operands,
    damp_profiles, operands, rows_plain,
)
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    _kernel_route, _vp_grad, count_launch, pick_route, reset_launches,
    scatter_rows,
)

K_CKPT = 16  # checkpoint interval of the Pallas kernel


def _route(kap, route):
    nz8, nx128 = kap.shape
    return pick_route("acoustic_pallas_backward", nz8, nx128, route,
                      acoustic_resident_plan)


def _checkpoints_cuda(kap, damp, src_amp, sz, sx, rrow, a, route=None):
    """B6's forward sweep: the four fields (vx, vz, px, pz) before every
    K_CKPT-th step, [ns, n_ck, 4, nz8, nx128] (src_amp [ns, n_ck*K])."""
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    ns, nt_pad = src_amp.shape
    n_ck = nt_pad // K_CKPT
    nz8, nx128 = kap.shape
    dev = kap.device
    route, plan = _route(kap, route)
    ckpt = torch.empty((ns, n_ck, 4, nz8, nx128), dtype=torch.float32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = [t.data_ptr() for t in (src_amp, sz, sx, rrow)]
    if route == "resident":
        cuda_build.call(
            dev, "b6_checkpoints_resident", kap.data_ptr(), *(t.data_ptr() for
            t in damp_profiles(damp)), *ptr, ckpt.data_ptr(), ns, nz8, nx128,
            n_ck, K_CKPT, *plan.args(), a, stream)
    else:
        st = torch.empty((ns, 4, nz8, nx128), dtype=torch.float32,
                         device=dev)
        cuda_build.call(
            dev, "b6_checkpoints", kap.data_ptr(), *(d.data_ptr() for d in
            damp), *ptr, st.data_ptr(), ckpt.data_ptr(), ns, nz8, nx128, n_ck,
            K_CKPT, a, stream)
    return ckpt


def _adjoint_cuda(kap, damp, wav, src_amp, sz, sx, rrow, ybar, ckpt, a,
                  inv_dx, route=None):
    """B6's reverse sweep from ``ckpt``: dJ/dkap [nz8, nx128]."""
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    ns, nt_pad = src_amp.shape
    n_ck = nt_pad // K_CKPT
    nz8, nx128 = kap.shape
    dev = kap.device
    route, plan = _route(kap, route)
    dg = (wav * inv_dx).contiguous()

    def buf(*lead):
        return torch.empty(lead + (nz8, nx128), dtype=torch.float32,
                           device=dev)

    dxv, dzv = buf(ns, K_CKPT), buf(ns, K_CKPT)
    gk_shots, gk = buf(ns), buf()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = [t.data_ptr() for t in (src_amp, dg, sz, sx, rrow, ybar, ckpt)]
    out = [t.data_ptr() for t in (dxv, dzv)]
    if route == "resident":
        stash = buf(ns, 4)
        cuda_build.call(
            dev, "b6_adjoint_resident", kap.data_ptr(), *(t.data_ptr() for t in
            damp_profiles(damp)), *ptr, *out, stash.data_ptr(),
            gk_shots.data_ptr(), gk.data_ptr(), ns, nz8, nx128, n_ck, K_CKPT,
            *plan.args(), a, stream)
    else:
        st, ast = buf(ns, 4), buf(ns, 4)
        cuda_build.call(
            dev, "b6_adjoint", kap.data_ptr(), *(d.data_ptr() for d in damp),
            *ptr, st.data_ptr(), ast.data_ptr(), *out, gk_shots.data_ptr(),
            gk.data_ptr(), ns, nz8, nx128, n_ck, K_CKPT, a, stream)
    return gk


def _gk_cuda(kap, damp, wav, src_amp, sz, sx, rrow, ybar, a, inv_dx,
             route=None):
    ns, nt_pad = src_amp.shape
    check_operands("acoustic_pallas_backward", kap, damp, src_amp, sz, sx,
                   rrow, ("ybar_rows", ybar, torch.float32,
                          (ns, nt_pad, kap.shape[1])))
    if nt_pad % K_CKPT:
        raise ValueError("acoustic_pallas_backward: rows must be padded to "
                         f"a multiple of {K_CKPT} steps")
    route, _ = _route(kap, route)
    ckpt = _checkpoints_cuda(kap, damp, src_amp, sz, sx, rrow, a, route)
    gk = _adjoint_cuda(kap, damp, wav, src_amp, sz, sx, rrow, ybar, ckpt, a,
                       inv_dx, route)
    count_launch(acoustic_pallas_backward, route)
    return gk


def acoustic_pallas_backward_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                                   cfg: AcousticConfig, ybar_rows, *,
                                   dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`acoustic_pallas_backward` (any
    device): autograd of sum(rows * ybar_rows) through the plain forward
    with B6's source gain, checkpointed every 16 steps.  The operands
    are prepared in float32 as the kernel gets them;
    ``dtype=torch.float64`` runs the time loop without float32
    rounding."""
    g = cfg.grid
    nt_pad = ybar_rows.shape[1]
    with torch.enable_grad():
        v = vp.detach().to(torch.float32).requires_grad_(True)
        kap, damp, _, src_amp, sz, sx, rrow = operands(
            v, wavelet, src_z, src_x, rcv_z, cfg, nt_pad=nt_pad, gain="b6")
        kap, src_amp = kap.to(dtype), src_amp.to(dtype)
        damp = tuple(d.to(dtype) for d in damp)
        hist = rows_plain(kap, damp, src_amp, sz, sx, rrow,
                          g.dt * (1.0 / g.dx), chunk=K_CKPT)
        (gvp,) = torch.autograd.grad(
            torch.sum(hist * ybar_rows.to(dtype)), v)
    return gvp


@torch.no_grad()
def acoustic_pallas_backward(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                             cfg: AcousticConfig, ybar_rows, *, route=None):
    """dJ/dvp [nz, nx] for receiver-row cotangents ``ybar_rows``
    [ns, nt_pad, nx128] (nt_pad = nt rounded up to 16 steps; every row
    injected): the exact transpose of :func:`acoustic_forward_pallas`'s
    scheme, the chain rule kap = vp^2 dt/dx and the edge-pad transpose
    (port of ``_pallas_backward``).

    On a CUDA ``vp`` this launches kernel B6 (both sweeps) on the route
    that ``scalar2.pick_route`` gives ``route`` with
    ``kernels.acoustic_resident_plan`` (by default the resident route
    where that plan holds the grid);
    ``acoustic_pallas_backward.launches`` counts the launches,
    ``resident_launches`` and ``per_step_launches`` each route's.  On a
    CPU ``vp`` it runs :func:`acoustic_pallas_backward_plain`.  Any
    other device raises.
    """
    if not _kernel_route(vp, "acoustic_pallas_backward"):
        return acoustic_pallas_backward_plain(vp, wavelet, src_z, src_x,
                                              rcv_z, rcv_x, cfg, ybar_rows)
    g = cfg.grid
    kap, damp, wav, src_amp, sz, sx, rrow = operands(
        vp, wavelet, src_z, src_x, rcv_z, cfg, nt_pad=ybar_rows.shape[1],
        gain="b6")
    gk = _gk_cuda(kap, damp, wav, src_amp, sz, sx, rrow, ybar_rows,
                  g.dt * (1.0 / g.dx), 1.0 / g.dx, route)
    return _vp_grad(gk, vp, cfg, g.dt / g.dx)


reset_launches(acoustic_pallas_backward)


class _AcousticPallas(torch.autograd.Function):
    """Forward B5, saving only the inputs; backward scatters the trace
    cotangents into receiver rows and runs B6 (its own forward sweep
    included).  The wavelet's cotangent is zero, as the JAX package's
    custom VJP returns it."""

    @staticmethod
    def forward(ctx, vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg):
        ctx.cfg = cfg
        ctx.geom = (src_z, src_x, rcv_z, rcv_x)
        ctx.save_for_backward(vp, wavelet)
        return acoustic_forward_pallas(vp, wavelet, src_z, src_x, rcv_z,
                                       rcv_x, cfg)

    @staticmethod
    def backward(ctx, ybar):
        vp, wavelet = ctx.saved_tensors
        g = ctx.cfg.grid
        gvp = gw = None
        if ctx.needs_input_grad[0]:
            rows = scatter_rows(ybar.to(torch.float32), ctx.geom[3], nt=g.nt,
                                nx=g.nx, pml_width=g.pml_width, KC=K_CKPT)
            gvp = acoustic_pallas_backward(vp, wavelet, *ctx.geom, ctx.cfg,
                                           rows)
        if ctx.needs_input_grad[1]:
            gw = torch.zeros_like(wavelet)
        return gvp, gw, None, None, None, None, None


def acoustic_pallas(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                    cfg: AcousticConfig) -> torch.Tensor:
    """Differentiable first-order acoustic simulation, receivers
    [ns, nt, nr]: the contract of :func:`simulate_acoustic`, with a
    gradient w.r.t. ``vp`` only (the wavelet's is zero).  On this
    package it runs the CUDA kernels B5 forward and B6 backward on a
    CUDA ``vp``, their plain versions on a CPU one.  Records only row
    ``rcv_z[:, 0]`` of each shot, as the Pallas kernels do."""
    return _AcousticPallas.apply(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                                 cfg)
