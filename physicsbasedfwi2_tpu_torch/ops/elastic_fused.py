"""Fused elastic FWI loss+gradient (kernel B3) and the ring forward.

Port of ``physicsbasedfwi2_tpu/ops/pallas_elastic_fused.py``
(``prep_medium``, ``prep_damp``, ``scatter_rows_el``,
``fused_elastic_loss_grad_meds``, ``fused_elastic_loss_grad``,
``simulate_elastic_ring``; Pallas kernel ``_kernel``).  One call of
:func:`fused_elastic_loss_grad_meds` computes, for every shot:

1. the forward sweep of the 5-field sponge scheme with a checkpoint of
   the whole state every KC steps and the receiver-row history of vx
   and vz,
2. the misfit and its cotangent rows: ``l2`` (DENISE's raw MSE) or
   ``tnl1`` (trace-normalized L1 with the exact per-trace max
   subgradient, as in :mod:`fwi_fused`),
3. the reverse sweep: restore each chunk, recompute it caching the five
   derivative combinations (t1, t2, a, b, c), and run the exact
   transpose, accumulating dJ/d(lam, l2m, mu_xz, bx, bz).

Forward step (dtx = dt/dx; D{x,z}{f,b} = 4th-order staggered
derivatives in grid units, zero outside the array):

    t1  = Dxf(sxx) + Dzb(sxz);   vx' = damp*(vx + dtx*bx*t1)
    t2  = Dxb(sxz) + Dzf(szz);   vz' = damp*(vz + dtx*bz*t2)
    a   = Dxb(vx');  b = Dzb(vz')
    sxx' = damp*(sxx + dtx*(l2m*a + lam*b)) + s_t
    szz' = fs * (damp*(szz + dtx*(lam*a + l2m*b)) + s_t)
    c   = Dxf(vz') + Dzf(vx');   sxz' = damp*(sxz + dtx*muxz*c)

with s_t = wav_t * dt/dx^2 * l2m[src] at the source cell.  Pallas reads
neighbours with circular rolls; the 2-cell zero ring folded into
``damp`` keeps every field 0 near the array edge, so reading 0 outside
the array gives the same values.

:func:`fused_elastic_loss_grad_meds` launches the hand-written CUDA
kernel on CUDA tensors and runs
:func:`fused_elastic_loss_grad_meds_plain`, the same algorithm in plain
PyTorch batched over shots, on CPU tensors.  The kernel has two routes
with the same arithmetic (bit-equal results): the resident one
(``csrc/elastic.cu::b3_fused_elastic_loss_grad_resident``, one
thread-block cluster per shot holding the wavefields in shared memory
through both sweeps, one launch per sweep) wherever
:func:`elastic_resident_plan` holds the grid (the marmousi_elastic
family's 128 x 384 in 8-row bands with the media in shared memory,
layout 0; seam_elastic's 144 x 384 and real_data's 192 x 384 in 9- and
12-row bands with the media read through L1 and the gradient
accumulators in shared memory, layout 1: :func:`el_smem`), and the
per-step one (``b3_fused_elastic_loss_grad``, launches per time step)
elsewhere; the choice is made by shape before any launch
(``scalar2.pick_route``).  :func:`simulate_elastic_ring` runs B3's
forward sweep alone on the same two routes: the resident one
(``b3_elastic_ring_resident``, one launch of the sweep without
checkpoints, shots in waves of the clusters the card keeps resident)
wherever :func:`elastic_forward_plan` (bands of 8 or 9 rows in layout 0,
12 in layout 1) holds the grid, the per-step one (``b3_elastic_ring``)
elsewhere.  Gradients w.r.t. (vp, vs, rho) come from ``torch.autograd``
through :func:`prep_medium`.
"""

from __future__ import annotations

from functools import partial

import torch

from physicsbasedfwi2_tpu_torch.ops import pml
from physicsbasedfwi2_tpu_torch.ops.acoustic import edge_pad
from physicsbasedfwi2_tpu_torch.ops.elastic import (
    ElasticConfig, _staggered_medium,
)
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    SMEM_LIMIT, ResidentPlan, _round_up, check_tensors, count_launch,
    pick_route, reset_launches,
)
from physicsbasedfwi2_tpu_torch.ops.scan_utils import closure_scan
from physicsbasedfwi2_tpu_torch.ops.stencil import _shift

RING = 2  # zero ring width (stands in for circular rolls)
EPS = 1e-10
_C1, _C2 = 9.0 / 8.0, -1.0 / 24.0
# B3's resident route (csrc/elastic.cu): bands of R rows, one thread a
# column, at most EL_MAX_COLS threads (168 registers each) and
# EL_MAX_CLUSTER CTAs (a non-portable cluster size), in one of two
# shared-memory layouts (el_smem): 0 holds the band's media, 1 reads them
# through L1 and holds B3's gradient accumulators.  The (R, layout) pairs
# each planner tries, in order: B3 has bands of EL_ROWS in layout 0 and
# of 9 or 12 rows in layout 1; the forward sweep alone (the ring forward,
# B8) of 8 or 9 rows in layout 0 and of 12 in layout 1.
EL_ROWS = 8
EL_B3_BANDS = ((EL_ROWS, 0), (9, 1), (12, 1))
EL_FWD_BANDS = ((EL_ROWS, 0), (9, 0), (12, 1))
EL_MAX_COLS = 384
EL_MAX_CLUSTER = 16


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def _layout(cfg: ElasticConfig):
    g = cfg.grid
    w = g.pml_width
    top = RING if g.free_surface else g.pml_width
    nzp = g.nz + top + w
    nxp = g.nx + 2 * w
    return top, w, nzp, nxp, _round_up(nzp, 8), _round_up(nxp, 128)


def prep_medium(vp, vs, rho, cfg: ElasticConfig, dtype=torch.float32):
    """(vp, vs, rho) -> kernel-layout (lam, l2m, muxz, bx, bz), each
    [nz8, nx128] in ``dtype`` (the kernels take float32).
    Differentiable: ``torch.autograd`` through it pulls the kernel's
    medium gradients back to the physical fields."""
    top, w, nzp, nxp, nz8, nx128 = _layout(cfg)
    vp_p, vs_p, rho_p = (edge_pad(a.to(dtype), top, w, w, w)
                         for a in (vp, vs, rho))
    lam, mu, muxz, bx, bz = _staggered_medium(vp_p, vs_p, rho_p)
    l2m = lam + 2.0 * mu
    return tuple(edge_pad(m, 0, nz8 - nzp, 0, nx128 - nxp)
                 for m in (lam, l2m, muxz, bx, bz))


def prep_damp(cfg: ElasticConfig, device="cpu"):
    """Sponge decay times the zero ring, kernel layout [nz8, nx128]."""
    g = cfg.grid
    top, w, nzp, nxp, nz8, nx128 = _layout(cfg)
    top_abs = 0 if g.free_surface else w
    sx = pml.sigma_profile(nxp, w, w, g.dx, cfg.vmax_pml,
                           device=device) * 0.5
    sz = pml.sigma_profile(nzp, top_abs, w, g.dx, cfg.vmax_pml,
                           device=device) * 0.5
    damp = torch.exp(-(sz[:, None] + sx[None, :]) * g.dt)
    full = torch.zeros((nz8, nx128), dtype=torch.float32, device=device)
    full[:nzp, :nxp] = damp
    full[:RING] = 0.0
    full[nzp - RING:] = 0.0
    full[:, :RING] = 0.0
    full[:, nxp - RING:] = 0.0
    return full


def scatter_rows_el(data, rcv_x, cfg: ElasticConfig, *, KC: int):
    """[ns, nt, nr] traces -> [ns, nt_pad, nx128] receiver-row layout
    (column = rcv_x + pml_width; duplicate columns add)."""
    g = cfg.grid
    _, w, _, _, _, nx128 = _layout(cfg)
    ns, nt, nr = data.shape
    nt_pad = -(-g.nt // KC) * KC
    cols = torch.as_tensor(rcv_x, device=data.device).long() + w
    rows = torch.zeros((ns, nt_pad, nx128), dtype=torch.float32,
                       device=data.device)
    rows[:, :nt].scatter_add_(2, cols[:, None, :].expand(ns, nt, nr),
                              data.to(torch.float32))
    return rows


def _geometry(cfg, l2m, wavelet, src_z, src_x, rcv_z, rcv_x, nt_pad):
    """Per-shot wavelet [ns, nt_pad] (zero past nt), padded int32
    source cells and receiver rows, the source gain dt/dx^2 l2m[src],
    the receiver-column mask [ns, nx128] and the free-surface row."""
    g = cfg.grid
    top, w, _, _, _, nx128 = _layout(cfg)
    dev = l2m.device
    ns = int(src_z.shape[0])
    wav = torch.as_tensor(wavelet, device=dev).to(torch.float32)
    if wav.ndim == 1:
        wav = wav[None, :].expand(ns, g.nt)
    wav = torch.nn.functional.pad(wav, (0, nt_pad - g.nt)).contiguous()

    def idx(a, off):
        return (torch.as_tensor(a, device=dev).to(torch.int32)
                + off).contiguous()

    sz, sx = idx(src_z, top), idx(src_x, w)
    rrow = idx(torch.as_tensor(rcv_z)[:, 0], top)
    gain = (g.dt / (g.dx * g.dx)) * l2m.detach()[sz.long(), sx.long()]
    cols = torch.as_tensor(rcv_x, device=dev).long() + w
    rmask = torch.zeros((ns, nx128), dtype=torch.float32, device=dev)
    rmask.scatter_(1, cols, 1.0)
    fs_row = top if g.free_surface else -1
    return wav, sz, sx, rrow, gain.contiguous(), rmask, fs_row


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _dxf(f):
    return _C1 * (_shift(f, 1, -1) - f) + _C2 * (_shift(f, 2, -1)
                                                 - _shift(f, -1, -1))


def _dxb(f):
    return _C1 * (f - _shift(f, -1, -1)) + _C2 * (_shift(f, 1, -1)
                                                  - _shift(f, -2, -1))


def _dzf(f):
    return _C1 * (_shift(f, 1, -2) - f) + _C2 * (_shift(f, 2, -2)
                                                 - _shift(f, -1, -2))


def _dzb(f):
    return _C1 * (f - _shift(f, -1, -2)) + _C2 * (_shift(f, 1, -2)
                                                  - _shift(f, -2, -2))


def _fwd_step(st, meds, damp, fs, dtx, src, amp):
    """One forward step for all shots: (new state, cache (t1, t2, a, b,
    c)).  ``amp`` [ns] is the scaled source sample."""
    vx, vz, sxx, szz, sxz = st
    lam, l2m, muxz, bx, bz = meds
    shot, sz, sx = src
    t1 = _dxf(sxx) + _dzb(sxz)
    vx = damp * (vx + dtx * bx * t1)
    t2 = _dxb(sxz) + _dzf(szz)
    vz = damp * (vz + dtx * bz * t2)
    a = _dxb(vx)
    b = _dzb(vz)
    sxx = damp * (sxx + dtx * (l2m * a + lam * b))
    sxx[shot, sz, sx] += amp
    szz = damp * (szz + dtx * (lam * a + l2m * b))
    szz[shot, sz, sx] += amp
    if fs is not None:
        szz = szz * fs
    cc = _dxf(vz) + _dzf(vx)
    sxz = damp * (sxz + dtx * muxz * cc)
    return (vx, vz, sxx, szz, sxz), (t1, t2, a, b, cc)


def _adj_step(cot, cache, meds, damp, fs, dtx, dt_invdx2, src, wav_t,
              gx, gz, rrow, gmed):
    """The exact transpose of :func:`_fwd_step` (in reverse assignment
    order, as the Pallas kernel runs it), accumulating into ``gmed``
    (per shot).  ``gx``/``gz`` [ns, nx128] are the receiver-row
    cotangents of vx'/vz'; ``wav_t`` [ns] the unscaled source sample."""
    Vx, Vz, Sxx, Szz, Sxz = cot
    t1, t2, a, b, cc = cache
    lam, l2m, muxz, bx, bz = meds
    glam, gl2m, gmuxz, gbx, gbz = gmed
    shot, sz, sx = src
    Vx = Vx.clone()
    Vz = Vz.clone()
    Vx[shot, rrow] += gx
    Vz[shot, rrow] += gz
    # 1. sxz' = damp*(sxz + dtx*muxz*c)
    w5 = damp * Sxz
    sxz_old = w5
    cbar = dtx * muxz * w5
    gmuxz += dtx * cc * w5
    Vz = Vz - _dxb(cbar)
    Vx = Vx - _dzb(cbar)
    # 2. szz' = fs*(damp*(szz + dtx*(lam a + l2m b)) + s_t)
    w4 = Szz * fs if fs is not None else Szz
    szz_old = damp * w4
    abar = dtx * lam * damp * w4
    bbar = dtx * l2m * damp * w4
    glam += dtx * a * damp * w4
    gl2m += dtx * b * damp * w4
    # 3. sxx' = damp*(sxx + dtx*(l2m a + lam b)) + s_t
    sxx_old = damp * Sxx
    abar = abar + dtx * l2m * damp * Sxx
    bbar = bbar + dtx * lam * damp * Sxx
    gl2m += dtx * a * damp * Sxx
    glam += dtx * b * damp * Sxx
    # source gain s_t = wav_t * dt/dx^2 * l2m[src]
    gl2m[shot, sz, sx] += wav_t * dt_invdx2 * (Sxx + w4)[shot, sz, sx]
    # 4. a = Dxb(vx'), b = Dzb(vz')
    Vx = Vx - _dxf(abar)
    Vz = Vz - _dzf(bbar)
    # 5. vz' = damp*(vz + dtx*bz*t2)
    w2 = damp * Vz
    t2bar = dtx * bz * w2
    gbz += dtx * t2 * w2
    sxz_old = sxz_old - _dxf(t2bar)
    szz_old = szz_old - _dzb(t2bar)
    # 6. vx' = damp*(vx + dtx*bx*t1)
    w1 = damp * Vx
    t1bar = dtx * bx * w1
    gbx += dtx * t1 * w1
    sxx_old = sxx_old - _dxb(t1bar)
    sxz_old = sxz_old - _dzf(t1bar)
    return (w1, w2, sxx_old, szz_old, sxz_old)


def _misfit_plain(hist, obs, rmask, nt, inv_count, misfit):
    """(summed misfit, cotangent rows) over one component's histories
    [ns, nt_pad, nx128].  ``tnl1`` divides by (m + eps) as
    trace_normalize does and carries the exact jnp.max subgradient
    (each tied maximum its own sign / cnt; sign(0) = 0)."""
    if misfit == "l2":
        live = (torch.arange(hist.shape[1], device=hist.device)
                < nt).to(hist.dtype)[None, :, None]
        d = (hist - obs) * rmask[:, None, :] * live
        return torch.sum(d * d), (2.0 * inv_count) * d
    m = torch.amax(torch.abs(hist), dim=1, keepdim=True)
    inv_m = 1.0 / (m + EPS)
    star = (torch.abs(hist) == m).to(hist.dtype)
    inv_cnt = 1.0 / torch.clamp(star.sum(dim=1, keepdim=True), min=1.0)
    yn = hist / (m + EPS)
    r = (yn - obs) * rmask[:, None, :]
    g = torch.sign(r) * inv_count
    S = torch.sum(g * yn, dim=1, keepdim=True)
    corr = inv_cnt * S * inv_m
    return torch.sum(torch.abs(r)), g * inv_m - star * torch.sign(hist) * corr


def _state(ns, shape, dtype, dev):
    return tuple(torch.zeros((ns,) + shape, dtype=dtype, device=dev)
                 for _ in range(5))


def _loss_gmeds_plain(meds, damp, wav, sz, sx, rrow, gain, obs_x, obs_z,
                      rmask, fs_row, nt, KC, dtx, dt_invdx2, inv_count,
                      misfit):
    """(loss, per-medium gradients) in plain PyTorch."""
    ns, nt_pad = wav.shape
    n_ck = nt_pad // KC
    shape = tuple(damp.shape)
    dtype, dev = damp.dtype, damp.device
    shot = torch.arange(ns, device=dev)
    src = (shot, sz.long(), sx.long())
    rrow = rrow.long()
    fs = None
    if fs_row >= 0:
        fs = torch.ones((shape[0], 1), dtype=dtype, device=dev)
        fs[fs_row] = 0.0

    # phase 1: forward sweep, checkpoints, receiver rows
    st = _state(ns, shape, dtype, dev)
    ckpt = []
    hx = torch.zeros((ns, nt_pad, shape[1]), dtype=dtype, device=dev)
    hz = torch.zeros_like(hx)
    for c in range(n_ck):
        ckpt.append(st)
        for kk in range(KC):
            t = c * KC + kk
            st, _ = _fwd_step(st, meds, damp, fs, dtx, src,
                              wav[:, t] * gain)
            if t < nt:
                hx[:, t] = st[0][shot, rrow]
                hz[:, t] = st[1][shot, rrow]

    # phase 2: misfit and cotangent rows
    lx, ybx = _misfit_plain(hx, obs_x, rmask, nt, inv_count, misfit)
    lz, ybz = _misfit_plain(hz, obs_z, rmask, nt, inv_count, misfit)
    loss = (lx + lz) * inv_count

    # phase 3: reverse sweep from the checkpoints (exact transpose)
    cot = _state(ns, shape, dtype, dev)
    gmed = _state(ns, shape, dtype, dev)
    for c in reversed(range(n_ck)):
        st = ckpt[c]
        caches = []
        for kk in range(KC):
            st, cache = _fwd_step(st, meds, damp, fs, dtx, src,
                                  wav[:, c * KC + kk] * gain)
            caches.append(cache)
        for kk in reversed(range(KC)):
            t = c * KC + kk
            cot = _adj_step(cot, caches[kk], meds, damp, fs, dtx, dt_invdx2,
                            src, wav[:, t], ybx[:, t], ybz[:, t], rrow, gmed)
    out = []
    for gs in gmed:
        acc = gs[0]
        for s in range(1, ns):
            acc = acc + gs[s]
        out.append(acc)
    return loss, tuple(out)


def _rows_plain(meds, damp, wav, sz, sx, rrow, gain, fs_row, nt, dtx,
                chunk: int = 32):
    """Receiver-row histories (vx, vz), each [ns, nt, nx128], from
    :func:`_fwd_step` on :func:`closure_scan` (``chunk`` steps a
    checkpoint): differentiable in ``meds`` and ``gain``, forward over
    reverse too."""
    ns = wav.shape[0]
    shape = tuple(damp.shape)
    dtype, dev = damp.dtype, damp.device
    shot = torch.arange(ns, device=dev)
    src = (shot, sz.long(), sx.long())
    rrow = rrow.long()
    fs = None
    if fs_row >= 0:
        fs = torch.ones((shape[0], 1), dtype=dtype, device=dev)
        fs[fs_row] = 0.0

    def step(st, x, params):
        (wav_t,) = x
        st, _ = _fwd_step(st, params[:5], damp, fs, dtx, src,
                          wav_t * params[5])
        return st, torch.stack([st[0][shot, rrow], st[1][shot, rrow]])

    _, rows = closure_scan(step, _state(ns, shape, dtype, dev),
                           (wav[:, :nt].T,), (*meds, gain), chunk=chunk)
    rows = rows.permute(1, 2, 0, 3)
    return rows[0], rows[1]


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/elastic.cu)
# ---------------------------------------------------------------------------

def el_smem(R: int, nx128: int, layout: int, reverse: bool) -> int:
    """Bytes of shared memory a CTA of R rows takes: 5 field buffers of
    (R + 4) x (nx128 + 8) floats (2 halo rows and 4 zero columns each
    side) and, in layout 0, the band's 6 media (both sweeps), in layout 1
    B3's 5 gradient accumulators at the band's cells (the reverse sweep
    only; the media are read through L1)."""
    fields = 5 * (R + 4) * (nx128 + 8)
    if layout == 0:
        return 4 * (fields + 6 * R * nx128)
    return 4 * (fields + (5 * R * nx128 if reverse else 0))


def _band_plan(nz8: int, nx128: int, bands,
               reverse: bool) -> ResidentPlan | None:
    """Bands of the first (R, layout) of ``bands`` whose R divides nz8
    into at most EL_MAX_CLUSTER CTAs and whose shared memory
    (:func:`el_smem`, of the reverse sweep where ``reverse``) is within
    SMEM_LIMIT, one thread a column (nx128 <= EL_MAX_COLS); None where
    no band fits."""
    if nx128 % 32 or nx128 > EL_MAX_COLS:
        return None
    for R, layout in bands:
        C = nz8 // R
        smem = el_smem(R, nx128, layout, reverse)
        if nz8 % R == 0 and 1 <= C <= EL_MAX_CLUSTER and smem <= SMEM_LIMIT:
            return ResidentPlan(C, R, nx128, smem, rows_per_thread=R,
                                layout=layout)
    return None


def elastic_resident_plan(nz8: int, nx128: int) -> ResidentPlan | None:
    """The resident plan of kernel B3 for an [nz8, nx128] grid, or None
    where it cannot hold the grid (the per-step route runs): the first
    band of EL_B3_BANDS that fits (:func:`_band_plan`).  At 128 x 384
    (the marmousi_elastic family) 16 CTAs of 8 rows in layout 0 and
    167,808 B; at 144 x 384 (seam_elastic) 16 of 9 rows in layout 1 and
    171,040 B; at 192 x 384 (real_data) 16 of 12 rows in layout 1 and
    217,600 B, of which the forward sweep takes the field buffers
    (101,920 and 125,440 B)."""
    return _band_plan(nz8, nx128, EL_B3_BANDS, reverse=True)


def elastic_forward_plan(nz8: int, nx128: int) -> ResidentPlan | None:
    """The resident plan of the forward sweep alone (the ring forward
    and B8) for an [nz8, nx128] grid, or None (the per-step route runs):
    the first band of EL_FWD_BANDS that fits (:func:`_band_plan`).  At
    128 x 384 B3's plan; at 144 x 384 (B8 at marmousi_elastic's shape,
    seam_elastic) 16 CTAs of 9 rows in layout 0 and 184,864 B; at 192 x
    384 (real_data) 16 of 12 rows in layout 1 and 125,440 B."""
    return _band_plan(nz8, nx128, EL_FWD_BANDS, reverse=False)


def elastic_forward_max_active_clusters(plan: ResidentPlan, ns: int,
                                        nz8: int, nx128: int) -> int:
    """cudaOccupancyMaxActiveClusters of the forward sweep's instance
    without checkpoints under ``plan`` (the ring forward's and B8's
    resident route): how many shots run at once (a query; launches
    nothing)."""
    import ctypes

    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    out = ctypes.c_int(0)
    cuda_build.call(
        None, "pbfwi_ring_max_clusters", ns, nz8, nx128, *plan.args(),
        plan.layout, ctypes.byref(out))
    return out.value


def elastic_max_active_clusters(plan: ResidentPlan, ns: int, nz8: int,
                                nx128: int, *, reverse: bool = False) -> int:
    """cudaOccupancyMaxActiveClusters of B3's resident forward (or
    reverse) kernel under ``plan``: how many shots the card runs at once
    (a query; launches nothing)."""
    import ctypes

    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    out = ctypes.c_int(0)
    cuda_build.call(
        None, "pbfwi_b3_max_clusters", int(reverse), ns, nz8, nx128,
        *plan.args(), plan.layout, ctypes.byref(out))
    return out.value


def _band_media(plan: ResidentPlan, nz8: int, dev):
    """Layout 1's scratch for its copy of the six media, band by band
    with rows of EL_MAX_COLS floats (csrc/elastic.cu::el_band_media), and
    its pointer; (None, None) for layout 0, which holds them in shared
    memory."""
    if plan.layout != 1:
        return None, None
    medb = torch.empty((6 * nz8 * EL_MAX_COLS,), dtype=torch.float32,
                       device=dev)
    return medb, medb.data_ptr()


def _loss_gmeds_cuda(meds, damp, wav, sz, sx, rrow, gain, obs_x, obs_z,
                     rmask, fs_row, nt, KC, dtx, dt_invdx2, inv_count,
                     misfit, route=None, plan=None):
    """B3's launch; ``plan`` (a resident plan that holds the grid, with
    ``route="resident"``) replaces the planner's, as chip_smoke.py does
    to time layout 1's 8-row band against layout 0's."""
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    ns, nt_pad = wav.shape
    n_ck = nt_pad // KC
    nz8, nx128 = damp.shape
    dev = damp.device
    f32, i32 = torch.float32, torch.int32
    med = torch.stack(meds).contiguous()
    check_tensors("fused_elastic_loss_grad_meds", dev, (
        ("meds", med, f32, (5, nz8, nx128)), ("damp", damp, f32, None),
        ("wavelet", wav, f32, None), ("src_z", sz, i32, (ns,)),
        ("src_x", sx, i32, (ns,)), ("rcv_row", rrow, i32, (ns,)),
        ("src_gain", gain, f32, (ns,)),
        ("obs_rows_x", obs_x, f32, (ns, nt_pad, nx128)),
        ("obs_rows_z", obs_z, f32, (ns, nt_pad, nx128)),
        ("rmask", rmask, f32, (ns, nx128))))
    if n_ck * KC != nt_pad or nt_pad < nt:
        raise ValueError("fused_elastic_loss_grad_meds: wavelet must be "
                         "padded to a multiple of KC >= nt")
    if misfit not in ("l2", "tnl1"):
        raise ValueError(f"fused_elastic_loss_grad_meds: misfit {misfit!r}")
    route, planned = pick_route("fused_elastic_loss_grad_meds", nz8, nx128,
                                route, elastic_resident_plan)
    if plan is None:
        plan = planned
    elif route != "resident":
        raise ValueError("fused_elastic_loss_grad_meds: a plan needs "
                         "route='resident'")

    def buf(*lead):
        return torch.empty(lead + (nz8, nx128), dtype=f32, device=dev)

    gmed_shots, ckpt, cache = buf(ns, 5), buf(n_ck, ns, 5), buf(KC, ns, 5)
    if route == "resident" and plan.layout == 1:
        # the cache band by band with rows of EL_MAX_COLS floats
        # (csrc/elastic.cu, BandR::cache_slot)
        cache = torch.empty((KC, ns, 5, nz8, EL_MAX_COLS), dtype=f32,
                            device=dev)
    hist = torch.empty((2, ns, nt_pad, nx128), dtype=f32, device=dev)
    loss_part = torch.empty((2, ns, nx128), dtype=torch.float64, device=dev)
    loss = torch.empty((), dtype=f32, device=dev)
    gmed = buf(5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() for a in (
        med, damp, wav, sz, sx, rrow, gain, obs_x, obs_z, rmask)]
    out = [a.data_ptr() for a in (ckpt, cache, hist, gmed_shots, loss_part,
                                  loss, gmed)]
    tnl1 = 1 if misfit == "tnl1" else 0
    if route == "resident":
        media, media_ptr = _band_media(plan, nz8, dev)
        cuda_build.call(
            dev, "b3_fused_elastic_loss_grad_resident", *ptrs, *out,
            media_ptr, ns, nz8, nx128, nt, n_ck, KC, fs_row, tnl1,
            *plan.args(), plan.layout, dtx, dt_invdx2, inv_count, stream)
    else:
        state, cot = buf(ns, 5), buf(ns, 5)
        cuda_build.call(
            dev, "b3_fused_elastic_loss_grad", *ptrs, state.data_ptr(),
            cot.data_ptr(), *out, ns, nz8, nx128, nt, n_ck, KC, fs_row, tnl1,
            dtx, dt_invdx2, inv_count, stream)
    count_launch(fused_elastic_loss_grad_meds, route)
    return loss, tuple(gmed.unbind(0))


def forward_rows_cuda(fn, meds, damp, wav, sz, sx, rrow, gain, fs_row, nt,
                      dtx, route=None):
    """Receiver rows (vx, vz), each [ns, nt, nx128], from one launch of
    B3's forward sweep without checkpoints, on the route that
    ``pick_route`` gives ``route`` with :func:`elastic_forward_plan`:
    the resident one (``b3_elastic_ring_resident``) or the per-step one
    (``b3_elastic_ring``).  The launch is counted on ``fn``, the entry
    point that made it: the ring forward, or B8 with ``fs_row`` -1.  A
    launch the card refuses raises."""
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    what = fn.__name__
    ns = wav.shape[0]
    nz8, nx128 = damp.shape
    dev = damp.device
    f32, i32 = torch.float32, torch.int32
    med = torch.stack(meds).contiguous()
    check_tensors(what, dev, (
        ("meds", med, f32, (5, nz8, nx128)), ("damp", damp, f32, None),
        ("wavelet", wav, f32, (ns, wav.shape[1])),
        ("src_z", sz, i32, (ns,)), ("src_x", sx, i32, (ns,)),
        ("rcv_row", rrow, i32, (ns,)), ("src_gain", gain, f32, (ns,))))
    if wav.shape[1] < nt:
        raise ValueError(f"{what}: wavelet shorter than nt")
    route, plan = pick_route(what, nz8, nx128, route, elastic_forward_plan)
    hist = torch.empty((2, ns, nt, nx128), dtype=f32, device=dev)
    ptrs = [a.data_ptr() for a in (med, damp, wav, sz, sx, rrow, gain)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "resident":
        media, media_ptr = _band_media(plan, nz8, dev)
        cuda_build.call(
            dev, "b3_elastic_ring_resident", *ptrs, hist.data_ptr(), media_ptr,
            ns, nz8, nx128, nt, wav.shape[1], fs_row, *plan.args(),
            plan.layout, dtx, stream)
    else:
        state = torch.empty((ns, 5, nz8, nx128), dtype=f32, device=dev)
        cuda_build.call(
            dev, "b3_elastic_ring", *ptrs, state.data_ptr(), hist.data_ptr(),
            ns, nz8, nx128, nt, wav.shape[1], fs_row, dtx, stream)
    count_launch(fn, route)
    return hist[0], hist[1]


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _loss_grad_meds(core, meds, damp, wavelet, src_z, src_x, rcv_z, rcv_x,
                    cfg, obs_rows_x, obs_rows_z, KC, misfit,
                    dtype=torch.float32):
    g = cfg.grid
    if misfit not in ("l2", "tnl1"):
        raise ValueError(f"misfit must be 'l2' or 'tnl1', not {misfit!r}")
    meds = tuple(m.detach().to(torch.float32).contiguous() for m in meds)
    damp = damp.to(torch.float32).contiguous()
    nr = int(rcv_x.shape[1])
    n_ck = -(-g.nt // KC)
    nt_pad = n_ck * KC
    wav, sz, sx, rrow, gain, rmask, fs_row = _geometry(
        cfg, meds[1], wavelet, src_z, src_x, rcv_z, rcv_x, nt_pad)
    inv_count = 1.0 / float(int(src_z.shape[0]) * g.nt * nr)
    if dtype != torch.float32:
        meds = tuple(m.to(dtype) for m in meds)
        damp, wav, gain, obs_rows_x, obs_rows_z, rmask = (
            a.to(dtype) for a in (damp, wav, gain, obs_rows_x, obs_rows_z,
                                  rmask))
    return core(meds, damp, wav, sz, sx, rrow, gain, obs_rows_x, obs_rows_z,
                rmask, fs_row, g.nt, KC, g.dt / g.dx, g.dt / (g.dx * g.dx),
                inv_count, misfit)


@torch.no_grad()
def fused_elastic_loss_grad_meds_plain(meds, damp, wavelet, src_z, src_x,
                                       rcv_z, rcv_x, cfg: ElasticConfig,
                                       obs_rows_x, obs_rows_z, *,
                                       KC: int = 8, misfit: str = "l2",
                                       dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`fused_elastic_loss_grad_meds`
    (any device).  The media and rows enter in float32, as the kernel
    gets them; ``dtype=torch.float64`` then runs the same discrete
    problem without float32 rounding (a reference for the kernel's
    error)."""
    return _loss_grad_meds(_loss_gmeds_plain, meds, damp, wavelet, src_z,
                           src_x, rcv_z, rcv_x, cfg, obs_rows_x, obs_rows_z,
                           KC, misfit, dtype)


@torch.no_grad()
def fused_elastic_loss_grad_meds(meds, damp, wavelet, src_z, src_x, rcv_z,
                                 rcv_x, cfg: ElasticConfig, obs_rows_x,
                                 obs_rows_z, *, KC: int = 8,
                                 misfit: str = "l2", route=None):
    """(loss, grads w.r.t. the 5 medium fields), summed over shots; the
    loss is scaled by 1/(ns nt nr).

    meds: output of :func:`prep_medium`; damp: :func:`prep_damp`.
    obs_rows_*: :func:`scatter_rows_el` layouts of the observed data
        (for ``misfit="tnl1"`` scattered from trace-normalized traces;
        receiver columns must be distinct within each shot).

    On a CUDA ``damp`` this launches kernel B3 on the route that
    ``scalar2.pick_route`` gives ``route`` with
    :func:`elastic_resident_plan` (by default the resident route where
    that plan holds the grid; "resident" raises where it does not);
    ``fused_elastic_loss_grad_meds.launches`` counts the launches,
    ``resident_launches`` and ``per_step_launches`` each route's.  On a
    CPU ``damp`` it runs :func:`fused_elastic_loss_grad_meds_plain`.
    Any other device raises.
    """
    if damp.device.type == "cpu":
        return fused_elastic_loss_grad_meds_plain(
            meds, damp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
            obs_rows_x, obs_rows_z, KC=KC, misfit=misfit)
    if damp.device.type != "cuda":
        raise ValueError(f"fused_elastic_loss_grad_meds: no kernel for "
                         f"device {damp.device}")
    return _loss_grad_meds(partial(_loss_gmeds_cuda, route=route), meds,
                           damp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
                           obs_rows_x, obs_rows_z, KC, misfit)


reset_launches(fused_elastic_loss_grad_meds)


def fused_elastic_loss_grad(vp, vs, rho, wavelet, src_z, src_x, rcv_z,
                            rcv_x, cfg: ElasticConfig, obs_rows_x,
                            obs_rows_z, *, KC: int = 8, misfit: str = "l2",
                            wrt=("vp", "vs")):
    """(loss, {field: dJ/dfield} over ``wrt``): the kernel's medium
    gradients pulled back to (vp, vs, rho) by ``torch.autograd``
    through :func:`prep_medium` (the JAX package uses ``jax.vjp``)."""
    fields = [a.detach().to(torch.float32).requires_grad_()
              for a in (vp, vs, rho)]
    damp = prep_damp(cfg, vp.device)
    with torch.enable_grad():
        meds = prep_medium(*fields, cfg)
    loss, gmeds = fused_elastic_loss_grad_meds(
        meds, damp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg, obs_rows_x,
        obs_rows_z, KC=KC, misfit=misfit)
    grads = torch.autograd.grad(meds, fields, grad_outputs=gmeds)
    named = dict(zip(("vp", "vs", "rho"), grads))
    return loss, {k: named[k] for k in wrt}


def _ring(rows_fn, vp, vs, rho, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
          dtype=torch.float32):
    g = cfg.grid
    meds = prep_medium(vp, vs, rho, cfg, dtype)
    damp = prep_damp(cfg, vp.device).to(dtype)
    wav, sz, sx, rrow, _, _, fs_row = _geometry(
        cfg, meds[1], wavelet, src_z, src_x, rcv_z, rcv_x, g.nt)
    # the source gain dt/dx^2 l2m[src], differentiable in l2m
    gain = (g.dt / (g.dx * g.dx)) * meds[1][sz.long(), sx.long()]
    hx, hz = rows_fn(meds, damp, wav.to(dtype), sz, sx, rrow, gain, fs_row,
                     g.nt, g.dt / g.dx)
    cols = torch.as_tensor(rcv_x, device=vp.device).long() + g.pml_width
    idx = cols[:, None, :].expand(-1, g.nt, -1)
    return torch.gather(hx, 2, idx), torch.gather(hz, 2, idx)


def simulate_elastic_ring_plain(vp, vs, rho, wavelet, src_z, src_x, rcv_z,
                                rcv_x, cfg: ElasticConfig):
    """Plain PyTorch version of :func:`simulate_elastic_ring` (the
    forward scan, any device).  Differentiable in (vp, vs, rho), as the
    JAX package's ``_ring_scan`` is: the landscape's elastic Hessian
    runs through it.  A float64 ``vp`` runs the loop in float64 (a
    reference for finite-difference checks)."""
    dtype = torch.float64 if vp.dtype == torch.float64 else torch.float32
    return _ring(partial(_rows_plain, chunk=cfg.chunk), vp, vs, rho,
                 wavelet, src_z, src_x, rcv_z, rcv_x, cfg, dtype)


@torch.no_grad()
def simulate_elastic_ring(vp, vs, rho, wavelet, src_z, src_x, rcv_z, rcv_x,
                          cfg: ElasticConfig, *, route=None):
    """Forward traces (vx, vz), each [ns, nt, nr], with the exact
    operator of the fused kernel: synthetic observed data made with it
    give a zero misfit at the true model.

    On a CUDA ``vp`` this launches B3's forward sweep on the route that
    ``scalar2.pick_route`` gives ``route`` with
    :func:`elastic_forward_plan` (by default the resident route where
    that plan holds the grid; "resident" raises where it does not);
    ``simulate_elastic_ring.launches`` counts the launches,
    ``resident_launches`` and ``per_step_launches`` each route's.  On a
    CPU ``vp`` it runs :func:`simulate_elastic_ring_plain`.  Any other
    device raises.
    """
    if vp.device.type == "cpu":
        return simulate_elastic_ring_plain(vp, vs, rho, wavelet, src_z,
                                           src_x, rcv_z, rcv_x, cfg)
    if vp.device.type != "cuda":
        raise ValueError(f"simulate_elastic_ring: no kernel for device "
                         f"{vp.device}")
    return _ring(partial(forward_rows_cuda, simulate_elastic_ring,
                         route=route),
                 vp, vs, rho, wavelet, src_z, src_x, rcv_z, rcv_x, cfg)


reset_launches(simulate_elastic_ring)
