"""Kernel B9: B2's forward sweep alone, each of its mechanisms switched on
at compile time (port of ``benchmarks/bench_kernel_breakdown.py``'s
``build_variant`` and its Pallas kernel ``_variant_kernel``).

The variants attribute the resident forward sweep's time to its parts,
each adding one mechanism to the one before (:data:`VARIANTS`):

    stencil  Laplacian, leapfrog and sponge only
    +src     the source: the raw amplitude wav[s, t] added at (src_z +
             top, src_x + pml) after the damping (no K factor, unlike
             B1's amp K[src])
    +rcv     the receiver row rcv_z[:, 0] of each new u0 recorded, t < nt
    +ckpt    (u0, u_-1) written before each chunk of KC steps

From u0 = K 1e-3, u_-1 = 0 (a nonzero field, so that the stencil-only
variant computes on real data), every variant runs ceil(nt/KC) KC steps
of ``u1 = d+ (2 u0 - d- u_-1 + K Lap(u0))``; ``chk[0, 0]`` is the sum
over shots, in shot order, of sum(u0[:8, :128]) at the end.

On a CUDA device :func:`build_variant` launches the hand-written kernel
``b9_variant_resident`` (``csrc/scalar2.cu``: ``b9_resident<flags>``, the
resident forward sweep ``fwd_sweep`` of B1, B2 and B4a with the variant's
flags as template parameters, so that each variant's registers show what
its mechanism costs), one thread-block cluster per shot on
:func:`scalar2.resident_plan`'s plan; a grid that no plan holds raises.
On the CPU it runs :func:`build_variant_plain`.  The JAX function
returns a jitted closure of the wavelet's scale; this one runs the sweep
and returns its outputs.  The TPU harness around it (timing, the rows it
prints) is not ported here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from physicsbasedfwi2_tpu_torch.device import default_device
from physicsbasedfwi2_tpu_torch.ops.acoustic import AcousticConfig
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    _lap, _prepare2, check_tensors, count_launch, pick_route,
    reset_launches,
)

# the cumulative variants of the JAX harness (measure_once), in order
VARIANTS = (
    ("stencil", dict()),
    ("+src", dict(with_src=True)),
    ("+rcv", dict(with_src=True, with_rcv=True)),
    ("+ckpt", dict(with_src=True, with_rcv=True, with_ckpt=True)),
)
SEED = 1e-3  # u0 = K * SEED at the start


class VariantOut(NamedTuple):
    """A variant's outputs: ``chk`` [8, 128] (only [0, 0] nonzero), the
    final fields ``u0`` and ``um1`` [ns, nz8, nx128], the receiver-row
    history ``hist`` [ns, nt, nx128] (None without ``with_rcv``) and the
    checkpoints ``ckpt`` [ns, n_ck, 2, nz8, nx128] (None without
    ``with_ckpt``)."""

    chk: torch.Tensor
    u0: torch.Tensor
    um1: torch.Tensor
    hist: torch.Tensor | None
    ckpt: torch.Tensor | None


def _inputs(vp, wavelet, src_z, src_x, rcv_z, cfg: AcousticConfig, KC: int,
            dev):
    """K, d+, d- on the [nz8, nx128] grid, the wavelet [ns, n_ck KC]
    zero-padded past nt, and the padded int32 source cell and receiver
    row, all on ``dev``."""
    g = cfg.grid
    vp = torch.as_tensor(vp, device=dev)
    K, dp, dm, _ = _prepare2(vp, cfg)
    ns = int(torch.as_tensor(src_z).shape[0])
    n_ck = -(-g.nt // KC)
    wav = torch.as_tensor(wavelet, device=dev).to(torch.float32)
    wav = torch.broadcast_to(wav, (ns, g.nt))
    wav = torch.nn.functional.pad(wav, (0, n_ck * KC - g.nt)).contiguous()
    top, w = g.top_pad, g.pml_width

    def idx(a, off):
        return (torch.as_tensor(a, device=dev).to(torch.int32)
                + off).contiguous()

    return (K, dp, dm, wav, idx(src_z, top), idx(src_x, w),
            idx(torch.as_tensor(rcv_z)[:, 0], top))


def _chk(corner: torch.Tensor) -> torch.Tensor:
    """[8, 128] zeros with [0, 0] the per-shot sums added in shot order."""
    acc = torch.zeros((), dtype=corner.dtype, device=corner.device)
    for c in corner:
        acc = acc + c
    chk = torch.zeros((8, 128), dtype=corner.dtype, device=corner.device)
    chk[0, 0] = acc
    return chk


def _variant_plain(K, dp, dm, wav, sz, sx, rrow, nt, KC, with_src,
                   with_rcv, with_ckpt) -> VariantOut:
    ns, ntp = wav.shape
    n_ck = ntp // KC
    nz8, nx128 = K.shape
    dev = K.device
    shot = torch.arange(ns, device=dev)
    sz, sx, rrow = sz.long(), sx.long(), rrow.long()
    u0 = (K * SEED).expand(ns, nz8, nx128).clone()
    um1 = torch.zeros_like(u0)
    hist = (torch.zeros((ns, nt, nx128), dtype=K.dtype, device=dev)
            if with_rcv else None)
    ckpt = (torch.empty((ns, n_ck, 2, nz8, nx128), dtype=K.dtype, device=dev)
            if with_ckpt else None)
    for c in range(n_ck):
        if with_ckpt:
            ckpt[:, c, 0] = u0
            ckpt[:, c, 1] = um1
        for kk in range(KC):
            t = c * KC + kk
            u1 = dp * (2.0 * u0 - dm * um1 + K * _lap(u0))
            if with_src:
                u1[shot, sz, sx] += wav[:, t]
            um1, u0 = u0, u1
            if with_rcv and t < nt:
                hist[:, t] = u0[shot, rrow]
    corner = u0[:, :8, :128].sum(dim=(1, 2))
    return VariantOut(_chk(corner), u0, um1, hist, ckpt)


def _variant_cuda(K, dp, dm, wav, sz, sx, rrow, nt, KC, with_src, with_rcv,
                  with_ckpt) -> VariantOut:
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    ns, ntp = wav.shape
    n_ck = ntp // KC
    nz8, nx128 = K.shape
    dev = K.device
    f32, i32 = torch.float32, torch.int32
    check_tensors("build_variant", dev, (
        ("K", K, f32, None), ("d+", dp, f32, K.shape),
        ("d-", dm, f32, K.shape), ("wavelet", wav, f32, (ns, ntp)),
        ("src_z", sz, i32, (ns,)), ("src_x", sx, i32, (ns,)),
        ("rcv_row", rrow, i32, (ns,))))
    _, plan = pick_route("build_variant", nz8, nx128, "resident")
    hist = (torch.zeros((ns, nt, nx128), dtype=f32, device=dev)
            if with_rcv else None)
    ckpt = (torch.empty((ns, n_ck, 2, nz8, nx128), dtype=f32, device=dev)
            if with_ckpt else None)
    fin = torch.empty((ns, 2, nz8, nx128), dtype=f32, device=dev)
    corner = torch.empty((ns,), dtype=f32, device=dev)
    chk = torch.zeros((8, 128), dtype=f32, device=dev)
    flags = int(with_src) | int(with_rcv) << 1 | int(with_ckpt) << 2
    cuda_build.call(
        dev, "b9_variant_resident",
        *[a.data_ptr() for a in (K, dp, dm, wav, sz, sx, rrow)],
        0 if hist is None else hist.data_ptr(),
        0 if ckpt is None else ckpt.data_ptr(), fin.data_ptr(),
        corner.data_ptr(), chk.data_ptr(), flags, ns, nz8, nx128, nt, n_ck,
        KC, *plan.args(), torch.cuda.current_stream(dev).cuda_stream)
    count_launch(build_variant, "resident")
    return VariantOut(chk, fin[:, 0], fin[:, 1], hist, ckpt)


def _run(variant_fn, vp, wavelet, src_z, src_x, rcv_z, cfg, KC, with_src,
         with_rcv, with_ckpt, dev, dtype=torch.float32):
    K, dp, dm, wav, sz, sx, rrow = _inputs(vp, wavelet, src_z, src_x,
                                           rcv_z, cfg, KC, dev)
    K, dp, dm, wav = (a.to(dtype) for a in (K, dp, dm, wav))
    return variant_fn(K, dp, dm, wav, sz, sx, rrow, cfg.grid.nt, KC,
                      with_src, with_rcv, with_ckpt)


def _device(vp, device) -> torch.device:
    """``device``; else ``vp``'s where it is a tensor, else the card."""
    if device is not None:
        return torch.device(device)
    if isinstance(vp, torch.Tensor):
        return vp.device
    return default_device()


@torch.no_grad()
def build_variant_plain(vp, wavelet, src_z, src_x, rcv_z,
                        cfg: AcousticConfig, *, KC: int = 32,
                        with_src: bool = False, with_rcv: bool = False,
                        with_ckpt: bool = False, device=None,
                        dtype: torch.dtype = torch.float32) -> VariantOut:
    """Plain PyTorch version of :func:`build_variant` (any device): the
    same sweep batched over shots, reading zeros outside the array where
    the TPU kernel rolls circularly (the zero ring in d+ makes the two
    equal).  The coefficients are prepared in float32, as the kernel gets
    them; ``dtype=torch.float64`` then runs the same discrete problem
    without float32 rounding (a reference for the kernel's error: the
    stencil-only sweep decays from a seed that varies cell by cell, and
    float32 alone moves its final field ~1e-3 of max)."""
    return _run(_variant_plain, vp, wavelet, src_z, src_x, rcv_z, cfg, KC,
                with_src, with_rcv, with_ckpt, _device(vp, device), dtype)


@torch.no_grad()
def build_variant(vp, wavelet, src_z, src_x, rcv_z, cfg: AcousticConfig, *,
                  KC: int = 32, with_src: bool = False,
                  with_rcv: bool = False, with_ckpt: bool = False,
                  device=None) -> VariantOut:
    """Kernel B9's variant with the mechanisms asked for, on ``vp``
    [nz, nx], ``wavelet`` [nt] (or [ns, nt]), ``src_z``/``src_x`` [ns]
    and ``rcv_z`` [ns, nr] (row ``rcv_z[:, 0]`` recorded) of the grid of
    ``cfg``; KC steps a chunk (checkpoints every KC steps, ceil(nt/KC)
    KC steps in all).  Runs on ``device`` (default: ``vp``'s where it is
    a tensor, else the card): on a CUDA device the kernel on the
    resident route (``build_variant.launches`` counts its launches; a
    grid that no resident plan holds raises), on the CPU
    :func:`build_variant_plain`; any other device raises.  Returns a
    :class:`VariantOut`."""
    dev = _device(vp, device)
    if dev.type == "cpu":
        return build_variant_plain(vp, wavelet, src_z, src_x, rcv_z, cfg,
                                   KC=KC, with_src=with_src,
                                   with_rcv=with_rcv, with_ckpt=with_ckpt,
                                   device=dev)
    if dev.type != "cuda":
        raise ValueError(f"build_variant: no kernel for device {dev}")
    return _run(_variant_cuda, vp, wavelet, src_z, src_x, rcv_z, cfg, KC,
                with_src, with_rcv, with_ckpt, dev)


reset_launches(build_variant)
