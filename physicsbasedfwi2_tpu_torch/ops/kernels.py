"""First-order acoustic forward on the padded grid (kernel B5).

Port of ``physicsbasedfwi2_tpu/ops/pallas_kernels.py`` (``_prepare``,
``acoustic_forward_pallas``; Pallas kernel ``_forward_kernel``): the
staggered 4-field split-PML scheme of :mod:`ops.acoustic` on the
[nz8, nx128] padded grid, with the four decay factors multiplied by a
2-cell zero ring, kap = kappa_dt/dx and a = dt/dx:

    p = px + pz
    vx = ax_v (vx + a Dxf(p)),    vz = az_v (vz + a Dzf(p))
    px = ax_p (px + kap Dxb(vx)), pz = az_p (pz + kap Dzb(vz)) + amp_t gain
    y_t = (px + pz)[rcv_row]

with gain = kappa_dt[src]/dx^2.  Receivers are assumed to lie on one
grid row per shot (row ``rcv_z[:, 0]``), as in the Pallas kernel: the
full row is recorded every step and the host gathers the receiver
columns.

:func:`acoustic_forward_pallas` launches the hand-written CUDA kernel
(``csrc/acoustic.cu``) on CUDA tensors and runs
:func:`acoustic_forward_pallas_plain`, the same scheme (ring,
association, order) batched over shots in plain PyTorch, on CPU
tensors.  The plain version is not :func:`simulate_acoustic`, which has
no ring and associates 1/dx differently.  The kernel has two routes
with the same arithmetic (bit-equal results), chosen by shape before
any launch: the resident one (``b5_acoustic_forward_resident``, one
thread-block cluster per shot holding the fields in shared memory for
the whole sweep), wherever :func:`acoustic_resident_plan` holds the
grid, and the per-step one (``b5_acoustic_forward``, two launches a
time step) elsewhere.  On this package the name means the CUDA kernel.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from physicsbasedfwi2_tpu_torch.ops.acoustic import (
    AcousticConfig, _damping, _pad_model, edge_pad,
)
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    ResidentPlan, _gather_cols, _kernel_route, _round_up, band_plan,
    check_tensors, count_launch, pick_route, reset_launches,
)
from physicsbasedfwi2_tpu_torch.ops.scan_utils import chunked_checkpoint_scan
from physicsbasedfwi2_tpu_torch.ops.stencil import _shift

_C1 = 9.0 / 8.0
_C2 = -1.0 / 24.0


def _dx_fwd(f):
    return _C1 * (_shift(f, 1, -1) - f) + _C2 * (_shift(f, 2, -1)
                                                 - _shift(f, -1, -1))


def _dx_bwd(f):
    return _C1 * (f - _shift(f, -1, -1)) + _C2 * (_shift(f, 1, -1)
                                                  - _shift(f, -2, -1))


def _dz_fwd(f):
    return _C1 * (_shift(f, 1, -2) - f) + _C2 * (_shift(f, 2, -2)
                                                 - _shift(f, -1, -2))


def _dz_bwd(f):
    return _C1 * (f - _shift(f, -1, -2)) + _C2 * (_shift(f, 1, -2)
                                                  - _shift(f, -2, -2))


def _prepare(vp, cfg: AcousticConfig):
    """kappa_dt, the four decay factors and the ring mask on the
    [nz8, nx128] padded grid (on vp's device, float32)."""
    g = cfg.grid
    dev = vp.device
    vp_pad = _pad_model(vp.to(torch.float32), g)
    nzp, nxp = vp_pad.shape
    nz8 = _round_up(nzp, 8)
    nx128 = _round_up(nxp, 128)
    kappa_dt = edge_pad(vp_pad * vp_pad * g.dt, 0, nz8 - nzp, 0,
                        nx128 - nxp)
    ax_v, az_v, ax_p, az_p = _damping(cfg, dev)

    def pad_x(a):  # [1, nxp] -> [nz8, nx128]
        return edge_pad(a, 0, 0, 0, nx128 - nxp).expand(nz8, nx128)

    def pad_z(a):  # [nzp, 1] -> [nz8, nx128]
        return edge_pad(a, 0, nz8 - nzp, 0, 0).expand(nz8, nx128)

    # ring mask: zero outer 2 cells of the padded domain plus everything
    # in the alignment pad
    rows = torch.zeros((nz8, 1), dtype=torch.float32, device=dev)
    rows[2: nzp - 2] = 1.0
    cols = torch.zeros((1, nx128), dtype=torch.float32, device=dev)
    cols[0, 2: nxp - 2] = 1.0
    ring = rows * cols
    return (kappa_dt, pad_x(ax_v), pad_z(az_v), pad_x(ax_p), pad_z(az_p),
            ring, (nz8, nx128))


def operands(vp, wavelet, src_z, src_x, rcv_z, cfg: AcousticConfig, *,
             nt_pad: int, gain: str):
    """What the kernels of this scheme take, on vp's device: kap =
    kappa_dt/dx and the four ring-masked decay factors (contiguous
    [nz8, nx128] float32, differentiable in vp), the per-shot wavelet
    zero-padded to ``nt_pad`` steps [ns, nt_pad], the source amplitude
    wavelet x gain [ns, nt_pad] (``gain="b5"``: kappa_dt[src]/dx^2, as
    the forward kernel computes it; ``"b6"``: kap[src]/dx, as the
    adjoint kernel does), and the padded int32 source cells and
    receiver rows [ns]."""
    g = cfg.grid
    dev = vp.device
    ns = int(src_z.shape[0])
    inv_dx = 1.0 / g.dx
    kappa_dt, ax_v, az_v, ax_p, az_p, ring, _ = _prepare(vp, cfg)
    kap = (kappa_dt * inv_dx).contiguous()
    damp = tuple((d * ring).contiguous() for d in (ax_v, az_v, ax_p, az_p))
    wav = torch.as_tensor(wavelet, device=dev).to(torch.float32)
    if wav.ndim == 1:
        wav = wav[None, :].expand(ns, g.nt)
    wav = F.pad(wav, (0, nt_pad - g.nt)).contiguous()

    def idx(a, off):
        return (torch.as_tensor(a, device=dev).to(torch.int32)
                + off).contiguous()

    sz = idx(src_z, g.top_pad)
    sx = idx(src_x, g.pml_width)
    rrow = idx(torch.as_tensor(rcv_z)[:, 0], g.top_pad)
    szl, sxl = sz.long(), sx.long()
    if gain == "b5":
        src_gain = kappa_dt[szl, sxl] * (inv_dx * inv_dx)
    else:
        src_gain = kap[szl, sxl] * inv_dx
    src_amp = (wav * src_gain[:, None]).contiguous()
    return kap, damp, wav, src_amp, sz, sx, rrow


def rows_plain(kap, damp, src_amp, sz, sx, rrow, a: float, *,
               chunk: int = 16):
    """Receiver-row history [ns, nt, nx128] of the scheme in plain
    PyTorch, batched over shots, time-stepped by
    :func:`chunked_checkpoint_scan` (so autograd through it is the exact
    transpose with O(nt/chunk + chunk) states kept)."""
    ns = src_amp.shape[0]
    ax_v, az_v, ax_p, az_p = damp
    shot = torch.arange(ns, device=kap.device)
    szl, sxl, rrl = sz.long(), sx.long(), rrow.long()

    def step(carry, x):
        vx, vz, px, pz = carry
        (amp_t,) = x
        p = px + pz
        vx = ax_v * (vx + a * _dx_fwd(p))
        vz = az_v * (vz + a * _dz_fwd(p))
        px = ax_p * (px + kap * _dx_bwd(vx))
        pz = az_p * (pz + kap * _dz_bwd(vz))
        pz = pz.index_put((shot, szl, sxl), amp_t, accumulate=True)
        return (vx, vz, px, pz), (px + pz)[shot, rrl]

    zero = torch.zeros((ns,) + tuple(kap.shape), dtype=kap.dtype,
                       device=kap.device)
    _, hist = chunked_checkpoint_scan(step, (zero,) * 4, (src_amp.T,),
                                      chunk=chunk)
    return hist.permute(1, 0, 2)


# ---------------------------------------------------------------------------
# Routes of the CUDA kernels B5 and B6 (csrc/acoustic.cu)
# ---------------------------------------------------------------------------

AC_PLANES = 4  # field planes a resident CTA holds (B6's adjoint needs 4)


def acoustic_resident_plan(nz8: int, nx128: int) -> ResidentPlan | None:
    """The resident plan of kernels B5 and B6 for an [nz8, nx128] grid,
    or None where no plan holds it (the per-step route runs): the
    smallest cluster whose bands fit (``scalar2.band_plan``), with
    shared memory for AC_PLANES field planes with 2 halo rows and 4
    zero columns each side, the band's kap and its rows' az_v and az_p
    (:func:`damp_profiles`; each thread holds its columns' ax_v and ax_p
    in registers).  At the flagship 192 x 256 that is 5 CTAs of 40 rows,
    512 threads and 227,136 B."""
    return band_plan(nz8, nx128, lambda H, R: 4 * (
        AC_PLANES * (H + 4) * (nx128 + 8) + R * nx128 + 2 * R))


def damp_profiles(damp):
    """The four ring-masked decay factors [nz8, nx128] as the resident
    kernels read them: ([2, nx128] ax_v, ax_p on the ring's rows, 0 off
    its columns; [2, nz8] az_v, az_p on the ring's columns, 0 off its
    rows).  Each factor is its profile times the 0/1 ring, so the
    kernels rebuild every value exactly: ax(i, j) = x[j] where az_v's
    profile is nonzero at row i, else 0 (and az the same way round)."""
    ax_v, az_v, ax_p, az_p = damp
    return (torch.stack((ax_v.amax(0), ax_p.amax(0))).contiguous(),
            torch.stack((az_v.amax(1), az_p.amax(1))).contiguous())


def acoustic_max_active_clusters(plan: ResidentPlan, ns: int, nz8: int,
                                 nx128: int, *,
                                 reverse: bool = False) -> int:
    """cudaOccupancyMaxActiveClusters of B5/B6's resident forward (or
    reverse) kernel under ``plan``: how many shots the card runs at once
    (a query; launches nothing)."""
    import ctypes

    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    out = ctypes.c_int(0)
    cuda_build.call(
        None, "pbfwi_b56_max_clusters", int(reverse), ns, nz8, nx128,
        *plan.args(), ctypes.byref(out))
    return out.value


def check_operands(what, kap, damp, src_amp, sz, sx, rrow, *extra):
    """Raise unless the scheme's operands (and ``extra`` specs, as
    :func:`scalar2.check_tensors` takes them) are what the kernels
    take."""
    ns = src_amp.shape[0]
    f32, i32 = torch.float32, torch.int32
    check_tensors(what, kap.device, (
        ("kap", kap, f32, None), *((n, d, f32, kap.shape) for n, d in zip(
            ("ax_v", "az_v", "ax_p", "az_p"), damp)),
        ("src_amp", src_amp, f32, None), ("src_z", sz, i32, (ns,)),
        ("src_x", sx, i32, (ns,)), ("rcv_row", rrow, i32, (ns,)), *extra))


def _rows_cuda(kap, damp, src_amp, sz, sx, rrow, a: float, route=None):
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    ns, nt = src_amp.shape
    nz8, nx128 = kap.shape
    dev = kap.device
    check_operands("acoustic_forward_pallas", kap, damp, src_amp, sz, sx,
                   rrow)
    route, plan = pick_route("acoustic_forward_pallas", nz8, nx128, route,
                             acoustic_resident_plan)
    hist = torch.empty((ns, nt, nx128), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = [t.data_ptr() for t in (src_amp, sz, sx, rrow)]
    if route == "resident":
        cuda_build.call(
            dev, "b5_acoustic_forward_resident", kap.data_ptr(), *(t.data_ptr()
            for t in damp_profiles(damp)), *ptr, hist.data_ptr(), ns, nz8,
            nx128, nt, *plan.args(), a, stream)
    else:
        st = torch.empty((ns, 4, nz8, nx128), dtype=torch.float32,
                         device=dev)
        cuda_build.call(
            dev, "b5_acoustic_forward", kap.data_ptr(), *(d.data_ptr() for d in
            damp), *ptr, st.data_ptr(), hist.data_ptr(), ns, nz8, nx128, nt, a,
            stream)
    count_launch(acoustic_forward_pallas, route)
    return hist


def _forward(rows_fn, vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
             dtype=torch.float32):
    g = cfg.grid
    kap, damp, _, src_amp, sz, sx, rrow = operands(
        vp, wavelet, src_z, src_x, rcv_z, cfg, nt_pad=g.nt, gain="b5")
    if dtype != torch.float32:
        kap, src_amp = kap.to(dtype), src_amp.to(dtype)
        damp = tuple(d.to(dtype) for d in damp)
    hist = rows_fn(kap, damp, src_amp, sz, sx, rrow, g.dt * (1.0 / g.dx))
    return _gather_cols(hist, rcv_x, g)


@torch.no_grad()
def acoustic_forward_pallas_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                                  cfg: AcousticConfig, *,
                                  dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`acoustic_forward_pallas` (any
    device).  The operands are prepared in float32, as the kernel gets
    them; ``dtype=torch.float64`` then runs the same discrete problem
    without float32 rounding."""
    return _forward(rows_plain, vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                    cfg, dtype)


@torch.no_grad()
def acoustic_forward_pallas(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                            cfg: AcousticConfig, *, route=None):
    """Forward simulation, receivers [ns, nt, nr]; the contract of
    :func:`simulate_acoustic` on this scheme.  Requires all receivers of
    a shot to share one grid row (row ``rcv_z[:, 0]`` is recorded).

    On a CUDA ``vp`` this launches kernel B5 on the route that
    ``scalar2.pick_route`` gives ``route`` with
    :func:`acoustic_resident_plan` (by default the resident route where
    that plan holds the grid; "resident" raises where it does not,
    "per_step" takes the per-step route);
    ``acoustic_forward_pallas.launches`` counts the launches,
    ``resident_launches`` and ``per_step_launches`` each route's.  On a
    CPU ``vp`` it runs :func:`acoustic_forward_pallas_plain`.  Any other
    device raises.
    """
    if not _kernel_route(vp, "acoustic_forward_pallas"):
        return acoustic_forward_pallas_plain(vp, wavelet, src_z, src_x,
                                             rcv_z, rcv_x, cfg)
    return _forward(partial(_rows_cuda, route=route), vp, wavelet, src_z,
                    src_x, rcv_z, rcv_x, cfg)


reset_launches(acoustic_forward_pallas)
