"""Second-order scalar wave equation: forward (kernel B1), forward with
checkpoints (B4a), its exact transpose (B4b) and the differentiable
propagator ``acoustic_pallas2`` built from them.

Port of ``physicsbasedfwi2_tpu/ops/pallas_scalar2.py`` (``_prepare2``,
``forward2``, ``forward2_ckpt``, ``_backward2``, ``acoustic_pallas2``;
Pallas kernels ``_fwd_kernel``, ``_fwd_ckpt_kernel``, ``_bwd_kernel``).
Scheme (K = vp^2 dt^2 / dx^2, sigma = Kosloff sponge profile, d+ =
1/(1+sigma dt/2), d- = 1-sigma dt/2, a 2-cell zero ring folded into
d+):

    u1 = d+ * (2 u0 - d- u_m1 + K Lap(u0)) + e_src * amp * K[src]
    y_t = u1[rrow]

Exact transpose, with (pb, qb) the cotangents of (u1, u0):

    pb += S^T ybar_t;  w = d+ pb;  Kbar += w Lap(u0)  [+ amp pb at src]
    (pb, qb) <- (qb + 2 w + Lap(K w), -d- w)

Each of :func:`forward2`, :func:`forward2_ckpt` and :func:`backward2`
launches its hand-written CUDA kernel (``csrc/scalar2.cu``) on CUDA
tensors and runs its plain PyTorch version, the same algorithm batched
over shots, on CPU tensors.  The kernels have two routes with the same
arithmetic: the resident one (one thread-block cluster per shot holding
the fields in shared memory for the whole sweep), taken wherever
:func:`resident_plan` holds the grid, and the per-step one (a launch per
time step) elsewhere; the choice is made by shape before any launch
(:func:`pick_route`).  Fields read zeros outside the array where Pallas
rolls circularly; the zero ring makes the two equal.  On this package
``acoustic_pallas2`` means those CUDA kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

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


def check_tensors(what: str, dev, specs) -> None:
    """Raise unless each (name, tensor, dtype, shape) of ``specs`` is a
    contiguous tensor of that dtype on ``dev`` with that shape (None:
    any shape): what a kernel's wrapper checks before passing
    pointers."""
    for name, a, dtype, shape in specs:
        if a.device != dev or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{dtype} tensor on {dev}")
        if shape is not None and tuple(a.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(a.shape)}, "
                             f"expected {tuple(shape)}")


def _check_common(what, K, dp, dm, wav, sz, sx, rrow):
    ns = wav.shape[0]
    f32, i32 = torch.float32, torch.int32
    check_tensors(what, K.device, (
        ("K", K, f32, None), ("d+", dp, f32, K.shape), ("d-", dm, f32, K.shape),
        ("wavelet", wav, f32, None), ("src_z", sz, i32, (ns,)),
        ("src_x", sx, i32, (ns,)), ("rcv_row", rrow, i32, (ns,))))


# ---------------------------------------------------------------------------
# Routes of the CUDA kernels B1, B2, B4a and B4b (csrc/scalar2.cu)
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232_448  # bytes of shared memory one block can use (H100)
MAX_CLUSTER = 8       # the portable thread-block cluster size
RES_THREADS = 512     # threads a CTA at most: 128 registers each
COLS_PER_THREAD = 4   # a thread's columns: one float4
ROWS_PER_THREAD = 5   # a thread's rows: the kernels' one template instance
ROUTES = ("resident", "per_step")


@dataclass(frozen=True)
class ResidentPlan:
    """Launch plan of the resident route for one [nz8, nx128] grid: one
    thread-block cluster of ``cluster`` CTAs per shot, CTA r owning rows
    [r R, min((r+1) R, nz8)) (R = ``band_rows``) across the full width,
    each of its ``threads`` threads a block of ``rows_per_thread`` rows,
    with ``smem_bytes`` of dynamic shared memory.  For B1, B2, B4a and
    B4b a thread's block is ROWS_PER_THREAD rows of COLS_PER_THREAD
    columns, and the shared memory holds two field buffers with 2 halo
    rows and 4 zero columns each side and the band's K, d+ and d-; B3's
    plan is :func:`elastic_fused.elastic_resident_plan`'s, B5's and
    B6's :func:`kernels.acoustic_resident_plan`'s.  ``layout`` names the
    kernel family's shared-memory layout where it has more than one
    (B3 and the ring forward: :func:`elastic_fused.el_smem`); the C
    entry points of those take it after :meth:`args`."""

    cluster: int
    band_rows: int
    threads: int
    smem_bytes: int
    rows_per_thread: int = ROWS_PER_THREAD
    layout: int = 0

    def args(self) -> tuple[int, ...]:
        """The plan as the C entry points take it."""
        return (self.cluster, self.band_rows, self.rows_per_thread,
                self.threads, self.smem_bytes)

    def bands(self, nz8: int) -> list[tuple[int, int]]:
        """Each CTA's rows as [start, stop)."""
        R = self.band_rows
        return [(r * R, min(nz8, (r + 1) * R)) for r in range(self.cluster)]


def resident_plan(nz8: int, nx128: int) -> ResidentPlan | None:
    """The resident route's plan for an [nz8, nx128] grid, or None where
    no plan holds it (the per-step route runs): the smallest cluster
    whose bands (a multiple of 8 rows, the last may be shorter) take at
    most RES_THREADS threads and SMEM_LIMIT bytes of shared memory.  At
    the flagship 192 x 256 that is 5 CTAs of 40 rows; the card keeps 22
    such clusters resident at once (cudaOccupancyMaxActiveClusters,
    chip_smoke.py), so 18 shots run in one wave."""
    return band_plan(nz8, nx128, lambda H, R: 4 * (
        2 * (H + 4) * (nx128 + 8) + 3 * R * nx128))


def band_plan(nz8: int, nx128: int, smem_of) -> ResidentPlan | None:
    """The smallest cluster whose bands (R rows, a multiple of 8; the
    last may be shorter) take at most RES_THREADS threads of
    ROWS_PER_THREAD x COLS_PER_THREAD cells and at most SMEM_LIMIT bytes
    of shared memory, ``smem_of(H, R)`` for H = the rows the threads
    cover; None where no cluster of at most MAX_CLUSTER CTAs fits."""
    per_row = nx128 // COLS_PER_THREAD
    for C in range(1, MAX_CLUSTER + 1):
        R = _round_up(-(-nz8 // C), 8)
        if -(-nz8 // R) != C:   # the same bands as a smaller cluster
            continue
        ty = -(-R // ROWS_PER_THREAD)
        smem = smem_of(ty * ROWS_PER_THREAD, R)
        if per_row * ty <= RES_THREADS and smem <= SMEM_LIMIT:
            return ResidentPlan(C, R, per_row * ty, smem)
    return None


def pick_route(what: str, nz8: int, nx128: int, route=None,
               plan_fn=resident_plan):
    """(route, plan) for a launch: ``route`` None takes the resident
    route where ``plan_fn`` (the kernel family's planner, by default
    :func:`resident_plan`) holds the grid and the per-step route
    elsewhere; "resident" (raises where no plan holds it) or "per_step"
    choose."""
    if route not in (None, *ROUTES):
        raise ValueError(f"{what}: route must be one of {ROUTES}, not "
                         f"{route!r}")
    plan = plan_fn(nz8, nx128)
    if route is None:
        route = "resident" if plan is not None else "per_step"
    if route == "resident" and plan is None:
        raise ValueError(f"{what}: no resident plan holds a {nz8} x "
                         f"{nx128} grid")
    return route, plan


def count_launch(fn, route: str) -> None:
    """Add one launch to ``fn``'s counts: ``launches`` and the route's
    own (``resident_launches`` or ``per_step_launches``)."""
    fn.launches += 1
    if route == "resident":
        fn.resident_launches += 1
    else:
        fn.per_step_launches += 1


def reset_launches(*fns) -> None:
    """Set every launch count of each of ``fns`` to 0."""
    for fn in fns:
        fn.launches = fn.resident_launches = fn.per_step_launches = 0


def max_active_clusters(plan: ResidentPlan, ns: int, nz8: int, nx128: int,
                        *, reverse: bool = False, group: int = 1) -> int:
    """cudaOccupancyMaxActiveClusters of the forward (or reverse)
    resident kernel under ``plan``, its instance for checkpoints grouped
    ``group`` shots at a time (1: B1, B2, B4; 2: B7's pairs): how many
    shots the card runs at once (a query; launches nothing)."""
    import ctypes

    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    out = ctypes.c_int(0)
    cuda_build.call(
        None, "pbfwi_resident_max_clusters", int(reverse), group, ns, nz8,
        nx128, *plan.args(), ctypes.byref(out))
    return out.value


def _rows_cuda(K, dp, dm, wav, sz, sx, rrow, nt, route=None):
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    ns = wav.shape[0]
    nz8, nx128 = K.shape
    dev = K.device
    _check_common("forward2", K, dp, dm, wav, sz, sx, rrow)
    if wav.shape != (ns, nt):
        raise ValueError("forward2: wavelet must be [ns, nt]")
    route, plan = pick_route("forward2", nz8, nx128, route)
    hist = torch.zeros((ns, nt, nx128), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() for a in (K, dp, dm, wav, sz, sx, rrow)]
    if route == "resident":
        cuda_build.call(
            dev, "b1_forward2_resident", *ptrs, hist.data_ptr(), ns, nz8,
            nx128, nt, *plan.args(), stream)
    else:
        u0 = torch.empty((ns, nz8, nx128), dtype=torch.float32, device=dev)
        um1 = torch.empty_like(u0)
        cuda_build.call(
            dev, "b1_forward2", *ptrs, u0.data_ptr(), um1.data_ptr(),
            hist.data_ptr(), ns, nz8, nx128, nt, stream)
    count_launch(forward2, route)
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
    return _gather_cols(hist, rcv_x, g)


def _gather_cols(hist, rcv_x, g):
    """Receiver traces [ns, nt, nr] from row histories [ns, >= nt, nx]."""
    cols = torch.as_tensor(rcv_x, device=hist.device).long() + g.pml_width
    return torch.gather(hist[:, :g.nt], 2,
                        cols[:, None, :].expand(-1, g.nt, -1))


def _kernel_route(vp, what: str) -> bool:
    """True for a CUDA ``vp`` (launch the kernel), False for a CPU one
    (run the plain version); any other device raises."""
    if vp.device.type == "cpu":
        return False
    if vp.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {vp.device}")
    return True


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
             cfg: AcousticConfig, *, return_rows: bool = False, route=None):
    """Second-order-scheme forward: traces [ns, nt, nr], or with
    ``return_rows`` the full receiver-row history [ns, nt, nx128] (the
    layout the fused kernel's dir/obs rows use).

    On a CUDA ``vp`` this launches kernel B1 on the route that
    :func:`pick_route` gives ``route`` (by default the resident route
    where its plan holds the grid); ``forward2.launches`` counts the
    launches, ``resident_launches`` and ``per_step_launches`` each
    route's.  On a CPU ``vp`` it runs :func:`forward2_plain`.  Any other
    device raises.
    """
    if not _kernel_route(vp, "forward2"):
        return forward2_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
                              return_rows=return_rows)
    return _forward2(partial(_rows_cuda, route=route), vp, wavelet, src_z,
                     src_x, rcv_z, rcv_x, cfg, return_rows)


# ---------------------------------------------------------------------------
# B4a (forward2_ckpt), B4b (backward2) and acoustic_pallas2
# ---------------------------------------------------------------------------

def _fwd_ckpt_plain(K, dp, dm, wav, sz, sx, rrow, nt, KC, dir_rows=None):
    """Forward sweep of n_ck*KC steps (wav [ns, n_ck*KC]) with (u0, u_-1)
    checkpoints [ns, n_ck, 2, nz8, nx128] every KC steps, and the
    receiver-row history [ns, n_ck*KC, nx128] (minus ``dir_rows``) for
    t < nt, zero after: B4a, and phase 1 of the fused kernel B2."""
    ns, nt_pad = wav.shape
    n_ck = nt_pad // KC
    nz8, nx128 = K.shape
    dev = K.device
    shot = torch.arange(ns, device=dev)
    sz, sx, rrow = sz.long(), sx.long(), rrow.long()
    gain = K[sz, sx]
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
                row = u0[shot, rrow]
                hist[:, t] = row if dir_rows is None else row - dir_rows[:, t]
    return hist, ckpt


def _bwd_plain_shots(K, dp, dm, wav, sz, sx, rrow, ybar, ckpt, nt_valid):
    """Reverse sweep from the checkpoints: restore each chunk, recompute
    it caching Lap(u0), and run the exact transpose, injecting the
    cotangent rows ``ybar`` [ns, n_ck*KC, nx128] for t < nt_valid.
    Returns dJ/dK of each shot [ns, nz8, nx128] and dJ/dwavelet
    [ns, n_ck*KC] (K[src] pb[src] after the row injection, the order of
    pallas_fwi_fused.py:210-226)."""
    ns, nt_pad = wav.shape
    n_ck = ckpt.shape[1]
    KC = nt_pad // n_ck
    nz8, nx128 = K.shape
    dev = K.device
    shot = torch.arange(ns, device=dev)
    sz, sx, rrow = sz.long(), sx.long(), rrow.long()
    gain = K[sz, sx]
    pb = torch.zeros((ns, nz8, nx128), dtype=K.dtype, device=dev)
    qb = torch.zeros_like(pb)
    gk = torch.zeros_like(pb)
    gw = torch.zeros_like(wav)
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
            if t < nt_valid:
                pb[shot, rrow] += ybar[:, t]
            w = dp * pb
            # the source is added after the damping: its cotangent is pb
            gk[shot, sz, sx] += wav[:, t] * pb[shot, sz, sx]
            gw[:, t] = pb[shot, sz, sx] * gain
            gk = gk + w * lapc[:, kk]
            pb, qb = qb + 2.0 * w + _lap(K * w), -(dm * w)
    return gk, gw


def _sum_shots(gk):
    """Per-shot dJ/dK [ns, ...] summed over shots in order, as the
    kernels sum it."""
    acc = gk[0]
    for s in range(1, gk.shape[0]):
        acc = acc + gk[s]
    return acc


def _bwd_plain(K, dp, dm, wav, sz, sx, rrow, ybar, ckpt, nt_valid):
    """:func:`_bwd_plain_shots`'s dJ/dK [nz8, nx128], shots summed in
    order: B4b, and phase 3 of the fused kernel B2."""
    gk, _ = _bwd_plain_shots(K, dp, dm, wav, sz, sx, rrow, ybar, ckpt,
                             nt_valid)
    return _sum_shots(gk)


def _fwd_ckpt_cuda(K, dp, dm, wav, sz, sx, rrow, nt, KC, route=None):
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    ns, nt_pad = wav.shape
    n_ck = nt_pad // KC
    nz8, nx128 = K.shape
    dev = K.device
    _check_common("forward2_ckpt", K, dp, dm, wav, sz, sx, rrow)
    if n_ck * KC != nt_pad or nt_pad < nt:
        raise ValueError("forward2_ckpt: wavelet must be padded to a "
                         "multiple of KC >= nt")
    route, plan = pick_route("forward2_ckpt", nz8, nx128, route)
    hist = torch.empty((ns, nt, nx128), dtype=torch.float32, device=dev)
    ckpt = torch.empty((ns, n_ck, 2, nz8, nx128), dtype=torch.float32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() for a in (K, dp, dm, wav, sz, sx, rrow)]
    if route == "resident":
        cuda_build.call(
            dev, "b4a_forward2_ckpt_resident", *ptrs, hist.data_ptr(),
            ckpt.data_ptr(), ns, nz8, nx128, nt, n_ck, KC, *plan.args(),
            stream)
    else:
        u0 = torch.empty((ns, nz8, nx128), dtype=torch.float32, device=dev)
        um1 = torch.empty_like(u0)
        cuda_build.call(
            dev, "b4a_forward2_ckpt", *ptrs, u0.data_ptr(), um1.data_ptr(),
            hist.data_ptr(), ckpt.data_ptr(), ns, nz8, nx128, nt, n_ck, KC,
            stream)
    count_launch(forward2_ckpt, route)
    return hist, ckpt


def _bwd_cuda(K, dp, dm, wav, sz, sx, rrow, ybar, ckpt, nt_valid,
              route=None):
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    ns, nt_pad = wav.shape
    n_ck = ckpt.shape[1]
    KC = nt_pad // n_ck
    nz8, nx128 = K.shape
    dev = K.device
    _check_common("backward2", K, dp, dm, wav, sz, sx, rrow)
    check_tensors("backward2", dev, (
        ("ybar_rows", ybar, torch.float32, (ns, nt_pad, nx128)),
        ("ckpt", ckpt, torch.float32, (ns, n_ck, 2, nz8, nx128))))
    if n_ck * KC != nt_pad or nt_valid != nt_pad:
        raise ValueError("backward2: checkpoints and rows disagree on KC")
    route, plan = pick_route("backward2", nz8, nx128, route)

    def field(*lead):
        return torch.empty(lead + (nz8, nx128), dtype=torch.float32,
                           device=dev)

    gk_shots, lapc, gk = field(ns), field(ns, KC), field()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() for a in (K, dp, dm, wav, sz, sx, rrow, ybar, ckpt)]
    if route == "resident":
        cuda_build.call(
            dev, "b4b_backward2_resident", *ptrs, gk_shots.data_ptr(),
            lapc.data_ptr(), gk.data_ptr(), ns, nz8, nx128, n_ck, KC,
            *plan.args(), stream)
    else:
        scratch = [field(ns) for _ in range(5)]  # u0, um1, pb0, pb1, qb
        cuda_build.call(
            dev, "b4b_backward2", *ptrs, *(a.data_ptr() for a in scratch),
            gk_shots.data_ptr(), lapc.data_ptr(), gk.data_ptr(), ns, nz8,
            nx128, n_ck, KC, stream)
    count_launch(backward2, route)
    return gk


def _common_padded(vp, wavelet, src_z, src_x, rcv_z, cfg, KC, dtype):
    """:func:`_common` with the wavelet zero-padded to n_ck*KC steps and
    the coefficients and wavelet in ``dtype``."""
    g = cfg.grid
    (K, dp, dm, _, _, wav, sz, sx,
     rrow) = _common(vp, wavelet, src_z, src_x, rcv_z, cfg)
    nt_pad = -(-g.nt // KC) * KC
    wav = F.pad(wav, (0, nt_pad - g.nt)).contiguous()
    K, dp, dm, wav = (a.to(dtype) for a in (K, dp, dm, wav))
    return K, dp, dm, wav, sz, sx, rrow


def _forward2_ckpt(fwd_fn, vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
                   KC, dtype=torch.float32):
    K, dp, dm, wav, sz, sx, rrow = _common_padded(
        vp, wavelet, src_z, src_x, rcv_z, cfg, KC, dtype)
    hist, ckpt = fwd_fn(K, dp, dm, wav, sz, sx, rrow, cfg.grid.nt, KC)
    return _gather_cols(hist, rcv_x, cfg.grid), ckpt


@torch.no_grad()
def forward2_ckpt_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                        cfg: AcousticConfig, *, KC: int = 32,
                        dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`forward2_ckpt` (any device;
    ``dtype=torch.float64`` as in :func:`forward2_plain`)."""
    return _forward2_ckpt(_fwd_ckpt_plain, vp, wavelet, src_z, src_x, rcv_z,
                          rcv_x, cfg, KC, dtype)


@torch.no_grad()
def forward2_ckpt(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                  cfg: AcousticConfig, *, KC: int = 32, route=None):
    """:func:`forward2`'s traces [ns, nt, nr] and the checkpoint buffer
    [ns, n_ck, 2, nz8, nx128] of (u0, u_-1) every KC steps, the wavelet
    zero-padded to n_ck*KC steps: the primal of
    :func:`acoustic_pallas2`.

    On a CUDA ``vp`` this launches kernel B4a on the route that
    :func:`pick_route` gives ``route`` (counts as :func:`forward2`'s);
    on a CPU ``vp`` it runs :func:`forward2_ckpt_plain`.  Any other
    device raises.
    """
    if not _kernel_route(vp, "forward2_ckpt"):
        return forward2_ckpt_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                                   cfg, KC=KC)
    return _forward2_ckpt(partial(_fwd_ckpt_cuda, route=route), vp, wavelet,
                          src_z, src_x, rcv_z, rcv_x, cfg, KC)


def _backward2(bwd_fn, vp, wavelet, src_z, src_x, rcv_z, cfg, ybar_rows,
               ckpt, dtype=torch.float32):
    g = cfg.grid
    KC = ybar_rows.shape[1] // ckpt.shape[1]
    K, dp, dm, wav, sz, sx, rrow = _common_padded(
        vp, wavelet, src_z, src_x, rcv_z, cfg, KC, dtype)
    gk = bwd_fn(K, dp, dm, wav, sz, sx, rrow, ybar_rows.to(dtype),
                ckpt.to(dtype), wav.shape[1])
    return _vp_grad(gk, vp, cfg, (g.dt / g.dx) ** 2)


@torch.no_grad()
def backward2_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                    cfg: AcousticConfig, ybar_rows, ckpt,
                    *, dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`backward2` (any device;
    ``dtype=torch.float64`` runs the same discrete problem without
    float32 rounding)."""
    return _backward2(_bwd_plain, vp, wavelet, src_z, src_x, rcv_z, cfg,
                      ybar_rows, ckpt, dtype)


@torch.no_grad()
def backward2(vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg: AcousticConfig,
              ybar_rows, ckpt, *, route=None):
    """dJ/dvp [nz, nx] of the second-order forward for receiver-row
    cotangents ``ybar_rows`` [ns, n_ck*KC, nx128] (every row injected),
    from :func:`forward2_ckpt`'s checkpoints: the exact transpose, the
    chain rule K = (vp dt/dx)^2 and the transpose of the edge padding
    (port of ``_backward2``).

    On a CUDA ``vp`` this launches kernel B4b on the route that
    :func:`pick_route` gives ``route`` (counts as :func:`forward2`'s);
    on a CPU ``vp`` it runs :func:`backward2_plain`.  Any other device
    raises.
    """
    if not _kernel_route(vp, "backward2"):
        return backward2_plain(vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg,
                               ybar_rows, ckpt)
    return _backward2(partial(_bwd_cuda, route=route), vp, wavelet, src_z,
                      src_x, rcv_z, cfg, ybar_rows, ckpt)


reset_launches(forward2, forward2_ckpt, backward2)


def _vp_grad(gk: torch.Tensor, vp: torch.Tensor, cfg: AcousticConfig,
             scale: float):
    """dJ/dvp [nz, nx] from a coefficient gradient gk on the padded grid,
    for a coefficient c = vp_pad^2 * scale (K = vp^2 (dt/dx)^2: scale
    (dt/dx)^2): the chain rule, then the transpose of the edge padding
    (pad-region gradient folds onto the edge rows/columns)."""
    g = cfg.grid
    top, w = g.top_pad, g.pml_width
    vp_pad = _pad_model(vp.to(torch.float32), g).to(gk.dtype)
    nzp, nxp = vp_pad.shape
    gz = gk[:nzp, :nxp] * (2.0 * vp_pad * scale)
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


def scatter_rows(data, rcv_x, *, nt, nx, pml_width, KC: int = 32):
    """[ns, nt, nr] traces -> [ns, nt_pad, nx128] receiver-row layout
    (duplicate columns add, as ``.at[].add`` does), in data's dtype."""
    ns, _, nr = data.shape
    nt_pad = -(-nt // KC) * KC
    nx128 = _round_up(nx + 2 * pml_width, 128)
    cols = torch.as_tensor(rcv_x, device=data.device).long() + pml_width
    rows = torch.zeros((ns, nt_pad, nx128), dtype=data.dtype,
                       device=data.device)
    rows[:, :nt].scatter_add_(2, cols[:, None, :].expand(ns, nt, nr), data)
    return rows


class _AcousticPallas2(torch.autograd.Function):
    """Forward B1 (no vp gradient wanted) or B4a, saving the
    checkpoints; backward scatters the trace cotangents into receiver
    rows and runs B4b.  The wavelet's cotangent is zero, as the JAX
    package's custom VJP returns it."""

    @staticmethod
    def forward(ctx, vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg):
        ctx.cfg = cfg
        ctx.geom = (src_z, src_x, rcv_z, rcv_x)
        if not ctx.needs_input_grad[0]:
            ctx.save_for_backward(vp, wavelet, None)
            return forward2(vp, wavelet, src_z, src_x, rcv_z, rcv_x, cfg)
        recs, ckpt = forward2_ckpt(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                                   cfg)
        ctx.save_for_backward(vp, wavelet, ckpt)
        return recs

    @staticmethod
    def backward(ctx, ybar):
        vp, wavelet, ckpt = ctx.saved_tensors
        g = ctx.cfg.grid
        gvp = gw = None
        if ctx.needs_input_grad[0]:
            rows = scatter_rows(ybar.to(torch.float32), ctx.geom[3], nt=g.nt,
                                nx=g.nx, pml_width=g.pml_width)
            gvp = backward2(vp, wavelet, *ctx.geom, ctx.cfg, rows, ckpt)
        if ctx.needs_input_grad[1]:
            gw = torch.zeros_like(wavelet)
        return gvp, gw, None, None, None, None, None


def acoustic_pallas2(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                     cfg: AcousticConfig) -> torch.Tensor:
    """Differentiable second-order-scheme propagator: traces [ns, nt, nr]
    with a gradient w.r.t. ``vp`` (the wavelet's is zero).  On this
    package it runs the CUDA kernels B1/B4a forward and B4b backward on
    a CUDA ``vp``, their plain versions on a CPU one.  Records only row
    ``rcv_z[:, 0]`` of each shot, as the Pallas kernels do."""
    return _AcousticPallas2.apply(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                                  cfg)
