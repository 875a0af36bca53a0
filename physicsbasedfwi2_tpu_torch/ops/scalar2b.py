"""Shot-pair second-order scalar propagator: forward with checkpoints
(kernel B7a), its exact transpose (B7b) and the differentiable
``acoustic_pallas2b`` built from them.

Port of ``physicsbasedfwi2_tpu/ops/pallas_scalar2b.py`` (``_common``,
``_pad_shots``, ``forward2b``, ``_backward2b``, ``acoustic_pallas2b``;
Pallas kernels ``_fwd_kernel``, ``_bwd_kernel``).  The scheme and its
transpose are :mod:`scalar2`'s (B4a/B4b); what differs is the layout:
shots in pairs (B = 2; an odd shot count is padded by repeating the last
shot), checkpoints of (u0, u_-1) every KC = 16 steps as
``[ns_p/B, n_ck, 2, B, nz8, nx128]``, and the gradient summed over the
two shots of a pair first, then over the pairs in order.

:func:`forward2b` and :func:`backward2b` launch hand-written CUDA
kernels on CUDA tensors and run their plain PyTorch versions on CPU
tensors: :mod:`scalar2`'s plain sweeps over the padded shots, put into
the pair layout.  The kernels have two routes, chosen by shape before
any launch as B4's are (:func:`scalar2.pick_route`): the resident one
(``csrc/scalar2.cu``: B4's resident sweeps, one thread-block cluster per
shot, with the checkpoints addressed in pairs, :func:`ckpt_offset`, and
the gradient summed in pair order) wherever :func:`scalar2.resident_plan`
holds the grid, and the per-step one (``csrc/scalar2b.cu``, a launch per
time step over all pairs) elsewhere.  Either route's checkpoints feed
either route's :func:`backward2b`.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from physicsbasedfwi2_tpu_torch.ops.acoustic import AcousticConfig
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    _bwd_plain_shots, _check_common, _common_padded, _fwd_ckpt_plain,
    _gather_cols, _kernel_route, _vp_grad, check_tensors, count_launch,
    pick_route, reset_launches, resident_plan, scatter_rows,
)

B = 2    # shots per pair
KC = 16  # checkpoint interval of the Pallas kernels


def _pad_shots(arrs, ns):
    """Pad shot-indexed tensors to a multiple of B shots by repeating the
    last shot; returns (tensors, padded shot count)."""
    target = -(-ns // B) * B
    pad = target - ns
    if pad == 0:
        return list(arrs), ns
    return [torch.cat([a] + [a[-1:]] * pad, dim=0).contiguous()
            for a in arrs], target


def _common(vp, wavelet, src_z, src_x, rcv_z, cfg, kc, dtype):
    """:mod:`scalar2`'s coefficients in ``dtype``, with the wavelet
    [ns_p, n_ck*kc] and the int32 geometry padded to ns_p shots."""
    K, dp, dm, wav, sz, sx, rrow = _common_padded(
        vp, wavelet, src_z, src_x, rcv_z, cfg, kc, dtype)
    (wav, sz, sx, rrow), _ = _pad_shots([wav, sz, sx, rrow],
                                        int(src_z.shape[0]))
    return K, dp, dm, wav, sz, sx, rrow


def _to_pairs(ckpt):
    """[ns_p, n_ck, 2, nz8, nx128] -> [ns_p/B, n_ck, 2, B, nz8, nx128]."""
    ns_p, n_ck = ckpt.shape[:2]
    return ckpt.reshape(ns_p // B, B, n_ck, 2, *ckpt.shape[3:]).permute(
        0, 2, 3, 1, 4, 5).contiguous()


def _from_pairs(ckpt):
    npair, n_ck = ckpt.shape[:2]
    return ckpt.permute(0, 3, 1, 2, 4, 5).reshape(
        npair * B, n_ck, 2, *ckpt.shape[4:])


def ckpt_offset(s: int, c: int, n_ck: int, plane: int, P: int = B) -> int:
    """Offset of shot s's u0 at checkpoint c in a flattened checkpoint
    buffer whose shots are grouped P at a time, [ns/P, n_ck, 2, P, nz8,
    nx128] with ``plane`` = nz8 nx128 (P = 2: :func:`_to_pairs`'s
    layout; P = 1: :mod:`scalar2`'s [ns, n_ck, 2, nz8, nx128]); its u_-1
    sits P planes further on.  The resident kernels address checkpoints
    with the same formula (``ckpt_offset<P>`` in ``csrc/scalar2.cu``)."""
    return (((s // P) * n_ck + c) * 2 * P + s % P) * plane


def _sum_pairs(gks):
    """Per-shot dJ/dK [ns_p, ...] summed as the Pallas kernel sums it:
    the two shots of a pair, then the pairs in order."""
    acc = gks[0] + gks[1]
    for p in range(1, gks.shape[0] // B):
        acc = acc + (gks[B * p] + gks[B * p + 1])
    return acc


def _fwd_plain(K, dp, dm, wav, sz, sx, rrow, nt, kc):
    hist, ckpt = _fwd_ckpt_plain(K, dp, dm, wav, sz, sx, rrow, nt, kc)
    return hist[:, :nt], _to_pairs(ckpt)


def _bwd_plain(K, dp, dm, wav, sz, sx, rrow, ybar, ckpt):
    gks, _ = _bwd_plain_shots(K, dp, dm, wav, sz, sx, rrow, ybar,
                              _from_pairs(ckpt), wav.shape[1])
    return _sum_pairs(gks)


def _fwd_cuda(K, dp, dm, wav, sz, sx, rrow, nt, kc, route=None):
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    ns_p, nt_pad = wav.shape
    n_ck = nt_pad // kc
    nz8, nx128 = K.shape
    dev = K.device
    _check_common("forward2b", K, dp, dm, wav, sz, sx, rrow)
    if ns_p % B or n_ck * kc != nt_pad or nt_pad < nt:
        raise ValueError("forward2b: shots must be padded to pairs and the "
                         "wavelet to a multiple of KC >= nt")
    route, plan = pick_route("forward2b", nz8, nx128, route,
                             plan_fn=resident_plan)
    hist = torch.empty((ns_p, nt, nx128), dtype=torch.float32, device=dev)
    ckpt = torch.empty((ns_p // B, n_ck, 2, B, nz8, nx128),
                       dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() for a in (K, dp, dm, wav, sz, sx, rrow)]
    sizes = (ns_p // B, nz8, nx128, nt, n_ck, kc)
    if route == "resident":
        cuda_build.call(
            dev, "b7a_forward2b_resident", *ptrs, hist.data_ptr(),
            ckpt.data_ptr(), *sizes, *plan.args(), stream)
    else:
        u0 = torch.empty((ns_p, nz8, nx128), dtype=torch.float32, device=dev)
        um1 = torch.empty_like(u0)
        cuda_build.call(
            dev, "b7a_forward2b", *ptrs, u0.data_ptr(), um1.data_ptr(),
            hist.data_ptr(), ckpt.data_ptr(), *sizes, stream)
    count_launch(forward2b, route)
    return hist, ckpt


def _bwd_cuda(K, dp, dm, wav, sz, sx, rrow, ybar, ckpt, route=None):
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    ns_p, nt_pad = wav.shape
    npair, n_ck = ckpt.shape[:2]
    kc = nt_pad // n_ck
    nz8, nx128 = K.shape
    dev = K.device
    _check_common("backward2b", K, dp, dm, wav, sz, sx, rrow)
    check_tensors("backward2b", dev, (
        ("ybar_rows", ybar, torch.float32, (ns_p, nt_pad, nx128)),
        ("ckpt", ckpt, torch.float32, (ns_p // B, n_ck, 2, B, nz8, nx128))))
    if ns_p % B or npair * B != ns_p or n_ck * kc != nt_pad:
        raise ValueError("backward2b: checkpoints, rows and shots disagree")
    route, plan = pick_route("backward2b", nz8, nx128, route,
                             plan_fn=resident_plan)

    def field(*lead):
        return torch.empty(lead + (nz8, nx128), dtype=torch.float32,
                           device=dev)

    gk_shots, gk = field(ns_p), field()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() for a in (K, dp, dm, wav, sz, sx, rrow, ybar, ckpt)]
    if route == "resident":
        lapc = field(ns_p, kc)
        cuda_build.call(
            dev, "b7b_backward2b_resident", *ptrs, gk_shots.data_ptr(),
            lapc.data_ptr(), gk.data_ptr(), npair, nz8, nx128, n_ck, kc,
            *plan.args(), stream)
    else:
        scratch = [field(ns_p) for _ in range(5)]  # u0, um1, pb0, pb1, qb
        lapc = field(kc, ns_p)
        cuda_build.call(
            dev, "b7b_backward2b", *ptrs, *(a.data_ptr() for a in scratch),
            gk_shots.data_ptr(), lapc.data_ptr(), gk.data_ptr(), npair, nz8,
            nx128, n_ck, kc, stream)
    count_launch(backward2b, route)
    return gk


def _forward2b(fwd_fn, vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg, kc,
               dtype=torch.float32):
    K, dp, dm, wav, sz, sx, rrow = _common(vp, wavelet, src_z, src_x, rcv_z,
                                           cfg, kc, dtype)
    hist, ckpt = fwd_fn(K, dp, dm, wav, sz, sx, rrow, cfg.grid.nt, kc)
    return _gather_cols(hist[:int(src_z.shape[0])], rcv_x, cfg.grid), ckpt


@torch.no_grad()
def forward2b_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                    cfg: AcousticConfig, *, KC: int = KC,
                    dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`forward2b` (any device;
    ``dtype=torch.float64`` runs the same discrete problem without
    float32 rounding)."""
    return _forward2b(_fwd_plain, vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                      cfg, KC, dtype)


@torch.no_grad()
def forward2b(vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg: AcousticConfig,
              *, KC: int = KC, route=None):
    """Traces [ns, nt, nr] of the second-order forward and the checkpoint
    buffer [ns_p/2, n_ck, 2, 2, nz8, nx128] of (u0, u_-1) every KC steps,
    shots in pairs (ns_p: ns rounded up to even, the last shot
    repeated).

    On a CUDA ``vp`` this launches kernel B7a on the route that
    :func:`scalar2.pick_route` gives ``route`` (by default the resident
    route where :func:`scalar2.resident_plan` holds the grid);
    ``forward2b.launches`` counts the launches, ``resident_launches``
    and ``per_step_launches`` each route's.  On a CPU ``vp`` it runs
    :func:`forward2b_plain`.  Any other device raises.
    """
    if not _kernel_route(vp, "forward2b"):
        return forward2b_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
                               KC=KC)
    return _forward2b(partial(_fwd_cuda, route=route), vp, wavelet, src_z,
                      src_x, rcv_z, rcv_x, cfg, KC)


def _backward2b(bwd_fn, vp, wavelet, src_z, src_x, rcv_z, cfg, ybar_rows,
                ckpt, dtype=torch.float32):
    g = cfg.grid
    kc = ybar_rows.shape[1] // ckpt.shape[1]
    K, dp, dm, wav, sz, sx, rrow = _common(vp, wavelet, src_z, src_x, rcv_z,
                                           cfg, kc, dtype)
    # the padded shots get zero cotangent rows, as the Pallas wrapper pads
    ybar = F.pad(ybar_rows.to(dtype),
                 (0, 0, 0, 0, 0, wav.shape[0] - ybar_rows.shape[0]))
    gk = bwd_fn(K, dp, dm, wav, sz, sx, rrow, ybar.contiguous(),
                ckpt.to(dtype))
    return _vp_grad(gk, vp, cfg, (g.dt / g.dx) ** 2)


@torch.no_grad()
def backward2b_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                     cfg: AcousticConfig, ybar_rows, ckpt,
                     *, dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`backward2b` (any device;
    ``dtype=torch.float64`` as in :func:`forward2b_plain`)."""
    return _backward2b(_bwd_plain, vp, wavelet, src_z, src_x, rcv_z, cfg,
                       ybar_rows, ckpt, dtype)


@torch.no_grad()
def backward2b(vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg: AcousticConfig,
               ybar_rows, ckpt, *, route=None):
    """dJ/dvp [nz, nx] for receiver-row cotangents ``ybar_rows``
    [ns or ns_p, n_ck*KC, nx128] (every row injected) from
    :func:`forward2b`'s checkpoints (either route's): the exact
    transpose, the chain rule K = (vp dt/dx)^2 and the transpose of the
    edge padding (port of ``_backward2b``).

    On a CUDA ``vp`` this launches kernel B7b on the route that
    :func:`scalar2.pick_route` gives ``route``, counted in
    ``backward2b``'s ``launches``, ``resident_launches`` and
    ``per_step_launches``; on a CPU ``vp`` it runs
    :func:`backward2b_plain`.  Any other device raises.
    """
    if not _kernel_route(vp, "backward2b"):
        return backward2b_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
                                ybar_rows, ckpt)
    return _backward2b(partial(_bwd_cuda, route=route), vp, wavelet, src_z,
                       src_x, rcv_z, cfg, ybar_rows, ckpt)


reset_launches(forward2b, backward2b)


class _AcousticPallas2b(torch.autograd.Function):
    """Forward B7a, saving the checkpoints; backward scatters the trace
    cotangents into receiver rows (duplicate columns add) and runs B7b.
    The wavelet's cotangent is zero, as the JAX package's custom VJP
    returns it."""

    @staticmethod
    def forward(ctx, vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg):
        ctx.cfg = cfg
        ctx.geom = (src_z, src_x, rcv_z, rcv_x)
        recs, ckpt = forward2b(vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg)
        ctx.save_for_backward(vp, wavelet, ckpt)
        return recs

    @staticmethod
    def backward(ctx, ybar):
        vp, wavelet, ckpt = ctx.saved_tensors
        g = ctx.cfg.grid
        gvp = gw = None
        if ctx.needs_input_grad[0]:
            rows = scatter_rows(ybar.to(torch.float32), ctx.geom[3], nt=g.nt,
                                nx=g.nx, pml_width=g.pml_width, KC=KC)
            gvp = backward2b(vp, wavelet, *ctx.geom, ctx.cfg, rows, ckpt)
        if ctx.needs_input_grad[1]:
            gw = torch.zeros_like(wavelet)
        return gvp, gw, None, None, None, None, None


def acoustic_pallas2b(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                      cfg: AcousticConfig) -> torch.Tensor:
    """Differentiable shot-pair second-order propagator: traces
    [ns, nt, nr] with a gradient w.r.t. ``vp`` (the wavelet's is zero).
    On this package it runs the CUDA kernels B7a forward and B7b
    backward on a CUDA ``vp`` (each on its default route: the resident
    one where the grid allows), their plain versions on a CPU one.
    Records only row ``rcv_z[:, 0]`` of each shot, as the Pallas kernels
    do."""
    return _AcousticPallas2b.apply(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                                   cfg)
