"""The hand-written CUDA kernels against their plain PyTorch versions,
at small shapes, on a CUDA card.

These need the card and ``nvcc`` (a CUDA kernel has no CPU or interpret
mode), so they skip elsewhere.  On a machine with a card and without
JAX, run them without the JAX-side conftest:
``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu_torch.geo import ricker
from physicsbasedfwi2_tpu_torch.ops import (
    adjoint, elastic_fwd, kernel_breakdown, kernels, scalar2, scalar2b,
)
from physicsbasedfwi2_tpu_torch.ops import elastic_fused as ef
from physicsbasedfwi2_tpu_torch.ops import trace_normalize
from physicsbasedfwi2_tpu_torch.ops.fwi_fused import (
    fwi_l1_loss_grad, fwi_l1_loss_grad_plain,
)
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    _prepare2, _rows_cuda, forward2, forward2_plain,
)

from torch_parity import (
    acoustic_case, elastic_case, rel_l2, rel_max, torch_acoustic,
    torch_elastic,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def case(dev):
    grid, cfg, wargs, vp, geom = acoustic_case()
    vp = vp + np.random.default_rng(9).uniform(-50, 50, vp.shape).astype(
        np.float32)
    geom = tuple(torch.as_tensor(a, device=dev) for a in geom)
    return (torch_acoustic(grid, cfg), ricker(*wargs, device=dev),
            torch.as_tensor(vp, device=dev), geom)


@pytest.mark.parametrize("return_rows", [False, True])
def test_forward2_kernel_matches_plain(case, return_rows):
    cfg, wav, vp, geom = case
    before = forward2.launches
    got = forward2(vp, wav, *geom, cfg, return_rows=return_rows)
    torch.cuda.synchronize()
    assert forward2.launches == before + 1
    ref = forward2_plain(vp, wav, *geom, cfg, return_rows=return_rows)
    # FMA contraction and sum order differ: 1e-5 of max over 180 steps
    assert rel_max(got, ref) <= 1e-5


@pytest.mark.parametrize("dir_scale", [0.0, 0.5])
def test_fused_kernel_matches_plain(case, dir_scale):
    cfg, wav, vp, geom = case
    g = cfg.grid
    gen = torch.Generator(device=vp.device).manual_seed(0)
    obs_rows = torch.zeros((2, 192, 128), device=vp.device)
    obs_rows[:, :g.nt] = torch.rand((2, g.nt, 128), generator=gen,
                                    device=vp.device) - 0.5
    direct = forward2_plain(torch.full_like(vp, 1700.0), wav, *geom, cfg,
                            return_rows=True)
    dir_rows = torch.nn.functional.pad(dir_scale * direct,
                                       (0, 0, 0, 192 - g.nt)).contiguous()
    before = fwi_l1_loss_grad.launches
    lk, gk = fwi_l1_loss_grad(vp, wav, *geom, cfg, obs_rows, dir_rows)
    torch.cuda.synchronize()
    assert fwi_l1_loss_grad.launches == before + 1
    lp, gp = fwi_l1_loss_grad_plain(vp, wav, *geom, cfg, obs_rows, dir_rows)
    # float32 rounding in another order: loss 1e-5, gradient 1e-4 rel L2
    np.testing.assert_allclose(float(lk), float(lp), rtol=1e-5)
    assert rel_l2(gk, gp) <= 1e-4


def test_kernel_wrapper_rejects_bad_inputs(case):
    cfg, wav, vp, geom = case
    K, dp, dm, _ = _prepare2(vp, cfg)
    sz = (geom[0] + 12).int()
    with pytest.raises(ValueError, match="contiguous"):
        _rows_cuda(K.double(), dp, dm, wav[None].expand(2, -1).contiguous(),
                   sz, sz, sz, cfg.grid.nt)
    with pytest.raises(ValueError, match="contiguous"):
        _rows_cuda(K, dp.t(), dm, wav[None].expand(2, -1).contiguous(),
                   sz, sz, sz, cfg.grid.nt)


@pytest.fixture(scope="module", params=[True, False],
                ids=["free_surface", "absorbing_top"])
def el_case(dev, request):
    grid, cfg, wargs, med, geom = elastic_case(free_surface=request.param)
    med = tuple(torch.as_tensor(a, device=dev) for a in med)
    geom = tuple(torch.as_tensor(a, device=dev) for a in geom)
    return torch_elastic(grid, cfg), ricker(*wargs, device=dev), med, geom


def test_ring_forward_kernel_matches_plain(el_case):
    cfg, wav, med, geom = el_case
    before = ef.simulate_elastic_ring.launches
    got = ef.simulate_elastic_ring(*med, wav, *geom, cfg)
    torch.cuda.synchronize()
    assert ef.simulate_elastic_ring.launches == before + 1
    ref = ef.simulate_elastic_ring_plain(*med, wav, *geom, cfg)
    for a, b in zip(got, ref):
        # FMA contraction and sum order differ: 1e-5 of max over 64 steps
        assert rel_max(a, b) <= 1e-5


@pytest.mark.parametrize("misfit", ["l2", "tnl1"])
def test_b3_kernel_matches_plain(el_case, misfit):
    cfg, wav, med, geom = el_case
    obs = ef.simulate_elastic_ring_plain(*med, wav, *geom, cfg)
    if misfit == "tnl1":
        obs = tuple(trace_normalize(o) for o in obs)
    rows = [ef.scatter_rows_el(o, geom[3], cfg, KC=8) for o in obs]
    meds = ef.prep_medium(med[0] * 0.9, med[1], med[2], cfg)
    damp = ef.prep_damp(cfg, wav.device)
    args = (meds, damp, wav, *geom, cfg, *rows)
    before = ef.fused_elastic_loss_grad_meds.launches
    lk, gk = ef.fused_elastic_loss_grad_meds(*args, KC=8, misfit=misfit)
    torch.cuda.synchronize()
    assert ef.fused_elastic_loss_grad_meds.launches == before + 1
    lp, gp = ef.fused_elastic_loss_grad_meds_plain(*args, KC=8,
                                                   misfit=misfit)
    # float32 rounding in another order: loss 1e-5, gradients 1e-4 rel L2
    np.testing.assert_allclose(float(lk), float(lp), rtol=1e-5)
    for a, b in zip(gk, gp):
        assert rel_l2(a, b) <= 1e-4


def test_b3_wrapper_rejects_bad_inputs(el_case):
    cfg, wav, med, geom = el_case
    meds = ef.prep_medium(*med, cfg)
    damp = ef.prep_damp(cfg, wav.device)
    g = cfg.grid
    nt_pad = -(-g.nt // 8) * 8
    wav2, sz, sx, rrow, gain, rmask, fs_row = ef._geometry(
        cfg, meds[1], wav, *geom, nt_pad)
    rows = torch.zeros((2, nt_pad, damp.shape[1]), device=wav.device)
    good = [meds, damp, wav2, sz, sx, rrow, gain, rows, rows, rmask, fs_row,
            g.nt, 8, 0.1, 0.1, 1e-3, "l2"]

    def call(i, bad):
        a = list(good)
        a[i] = bad
        return ef._loss_gmeds_cuda(*a)

    with pytest.raises(ValueError, match="contiguous"):
        call(1, damp.double())                 # dtype
    with pytest.raises(ValueError, match="contiguous"):
        call(7, rows.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        call(7, rows[:1])                      # shape
    with pytest.raises(ValueError, match="contiguous"):
        call(3, sz.long())


# ---------------------------------------------------------------------------
# B4a, B4b (acoustic_pallas2) and B5, B6 (acoustic_pallas)
# ---------------------------------------------------------------------------

def _l2_rows(case, forward, KC):
    """Receiver-row cotangents of mean((pred - obs)^2) at vp, with obs
    from 1.05 vp, both by ``forward``'s plain version."""
    cfg, wav, vp, geom = case
    g = cfg.grid
    pred = forward(vp, wav, *geom, cfg)
    obs = forward(vp * 1.05, wav, *geom, cfg)
    ybar = 2.0 * (pred - obs) / pred.numel()
    return scalar2.scatter_rows(ybar, geom[3], nt=g.nt, nx=g.nx,
                                pml_width=g.pml_width, KC=KC)


def test_b4a_kernel_matches_plain(case):
    cfg, wav, vp, geom = case
    before = scalar2.forward2_ckpt.launches
    recs, ckpt = scalar2.forward2_ckpt(vp, wav, *geom, cfg)
    torch.cuda.synchronize()
    assert scalar2.forward2_ckpt.launches == before + 1
    recs_p, ckpt_p = scalar2.forward2_ckpt_plain(vp, wav, *geom, cfg)
    # FMA contraction and sum order differ: 1e-5 of max over 180 steps
    assert rel_max(recs, recs_p) <= 1e-5
    assert rel_max(ckpt, ckpt_p) <= 1e-5
    # the same step kernel as B1
    assert torch.equal(recs, scalar2.forward2(vp, wav, *geom, cfg))


def test_b4b_kernel_matches_plain(case):
    cfg, wav, vp, geom = case
    rows = _l2_rows(case, scalar2.forward2_plain, 32)
    _, ckpt = scalar2.forward2_ckpt_plain(vp, wav, *geom, cfg)
    before = scalar2.backward2.launches
    got = scalar2.backward2(vp, wav, *geom, cfg, rows, ckpt)
    torch.cuda.synchronize()
    assert scalar2.backward2.launches == before + 1
    ref = scalar2.backward2_plain(vp, wav, *geom, cfg, rows, ckpt)
    # float32 rounding in another order: 1e-4 rel L2
    assert rel_l2(got, ref) <= 1e-4


def test_acoustic_pallas2_launches_b4a_and_b4b(case):
    cfg, wav, vp, geom = case
    counts = (scalar2.forward2_ckpt.launches, scalar2.backward2.launches)
    v = vp.clone().requires_grad_(True)
    scalar2.acoustic_pallas2(v, wav, *geom, cfg).square().sum().backward()
    torch.cuda.synchronize()
    assert (scalar2.forward2_ckpt.launches,
            scalar2.backward2.launches) == (counts[0] + 1, counts[1] + 1)
    assert bool(torch.isfinite(v.grad).all())


def test_b5_kernel_matches_plain(case):
    cfg, wav, vp, geom = case
    before = kernels.acoustic_forward_pallas.launches
    got = kernels.acoustic_forward_pallas(vp, wav, *geom, cfg)
    torch.cuda.synchronize()
    assert kernels.acoustic_forward_pallas.launches == before + 1
    ref = kernels.acoustic_forward_pallas_plain(vp, wav, *geom, cfg)
    # FMA contraction and sum order differ: 1e-5 of max over 180 steps
    assert rel_max(got, ref) <= 1e-5


def test_b6_kernel_matches_plain(case):
    cfg, wav, vp, geom = case
    rows = _l2_rows(case, kernels.acoustic_forward_pallas_plain, 16)
    before = adjoint.acoustic_pallas_backward.launches
    got = adjoint.acoustic_pallas_backward(vp, wav, *geom, cfg, rows)
    torch.cuda.synchronize()
    assert adjoint.acoustic_pallas_backward.launches == before + 1
    ref = adjoint.acoustic_pallas_backward_plain(vp, wav, *geom, cfg, rows)
    # float32 rounding in another order: 1e-4 rel L2
    assert rel_l2(got, ref) <= 1e-4


def test_acoustic_pallas_launches_b5_and_b6(case):
    cfg, wav, vp, geom = case
    counts = (kernels.acoustic_forward_pallas.launches,
              adjoint.acoustic_pallas_backward.launches)
    v = vp.clone().requires_grad_(True)
    adjoint.acoustic_pallas(v, wav, *geom, cfg).square().sum().backward()
    torch.cuda.synchronize()
    assert (kernels.acoustic_forward_pallas.launches,
            adjoint.acoustic_pallas_backward.launches) == (counts[0] + 1,
                                                           counts[1] + 1)
    assert bool(torch.isfinite(v.grad).all())


# ---------------------------------------------------------------------------
# B7a, B7b (acoustic_pallas2b), B8 (elastic_forward_pallas), B2's gwav
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ns", [2, 3])
def test_b7_kernels_match_b4_and_plain(case, ns):
    cfg, wav, vp, geom = case
    geom = tuple(torch.cat([a, a[:1]])[:ns].contiguous() for a in geom)
    before = scalar2b.forward2b.launches
    recs, ckpt = scalar2b.forward2b(vp, wav, *geom, cfg)
    torch.cuda.synchronize()
    assert scalar2b.forward2b.launches == before + 1
    recs_p, ckpt_p = scalar2b.forward2b_plain(vp, wav, *geom, cfg)
    # FMA contraction and sum order differ: 1e-5 of max over 180 steps
    assert rel_max(recs, recs_p) <= 1e-5
    assert rel_max(ckpt, ckpt_p) <= 1e-5
    # B4a's step arithmetic, per cell, for each shot of a pair
    assert rel_max(recs, scalar2.forward2(vp, wav, *geom, cfg)) <= 1e-6
    rows = _l2_rows((cfg, wav, vp, geom), scalar2.forward2_plain, 16)
    before = scalar2b.backward2b.launches
    got = scalar2b.backward2b(vp, wav, *geom, cfg, rows, ckpt_p)
    torch.cuda.synchronize()
    assert scalar2b.backward2b.launches == before + 1
    ref = scalar2b.backward2b_plain(vp, wav, *geom, cfg, rows, ckpt_p)
    # float32 rounding in another order: 1e-4 rel L2
    assert rel_l2(got, ref) <= 1e-4
    _, ck4 = scalar2.forward2_ckpt_plain(vp, wav, *geom, cfg, KC=16)
    assert rel_l2(got, scalar2.backward2(vp, wav, *geom, cfg, rows,
                                         ck4)) <= 1e-5


def test_b8_kernel_matches_plain_and_ring(dev):
    grid, cfgk, wargs, med, geom = elastic_case(free_surface=False)
    cfg = torch_elastic(grid, cfgk)
    wav = ricker(*wargs, device=dev)
    med = tuple(torch.as_tensor(a, device=dev) for a in med)
    geom = tuple(torch.as_tensor(a, device=dev) for a in geom)
    b8 = elastic_fwd.elastic_forward_pallas
    before = b8.launches
    got = b8(*med, wav, *geom, cfg)
    per = b8(*med, wav, *geom, cfg, route="per_step")
    torch.cuda.synchronize()
    assert b8.launches == before + 2
    ref = elastic_fwd.elastic_forward_pallas_plain(*med, wav, *geom, cfg)
    ring = ef.simulate_elastic_ring(*med, wav, *geom, cfg, route="per_step")
    for a, b, c, d in zip(got, ref, ring, per):
        # FMA contraction and sum order differ: 1e-5 of max over 64 steps
        assert rel_max(a, b) <= 1e-5
        # the ring forward's kernels with no free-surface row
        assert torch.equal(d, c)
        assert torch.equal(a, d)


def test_b2_wavelet_gradient_matches_plain(case):
    cfg, wav, vp, geom = case
    g = cfg.grid
    gen = torch.Generator(device=vp.device).manual_seed(1)
    obs_rows = torch.zeros((2, 192, 128), device=vp.device)
    obs_rows[:, :g.nt] = torch.rand((2, g.nt, 128), generator=gen,
                                    device=vp.device) + 2.5
    dir_rows = torch.zeros_like(obs_rows)
    lk, gk, wk = fwi_l1_loss_grad(vp, wav, *geom, cfg, obs_rows, dir_rows,
                                  want_wavelet_grad=True)
    lp, gp, wp = fwi_l1_loss_grad_plain(vp, wav, *geom, cfg, obs_rows,
                                        dir_rows, want_wavelet_grad=True)
    assert wk.shape == wp.shape == (2, g.nt)
    # residual signs fixed (obs > 2.5 > |yn|); float32 sums in another
    # order: 1e-4 rel L2
    np.testing.assert_allclose(float(lk), float(lp), rtol=1e-5)
    assert rel_l2(gk, gp) <= 1e-4
    assert rel_l2(wk, wp) <= 1e-4
    # without the flag the kernel returns what it returned before
    l2, g2 = fwi_l1_loss_grad(vp, wav, *geom, cfg, obs_rows, dir_rows)
    assert float(l2) == float(lk) and torch.equal(g2, gk)


# ---------------------------------------------------------------------------
# The resident route of B1, B2, B4a and B4b (one thread-block cluster per
# shot) against the per-step route and the plain versions
# ---------------------------------------------------------------------------

# 88 x 256 padded (64 x 176 and PML 12): the default plan is 3 CTAs of
# 32, 32 and 24 rows, a band count that does not divide the rows
RES_GRID = dict(nz=64, nx=176, dx=10.0, nt=180, dt=0.002, pml_width=12)
RES_BANDS = [(0, 32), (32, 64), (64, 88)]


def _edge_geom(dev, ns):
    """``ns`` shots, each with its source on one band's edge row and its
    receivers on the neighbouring band's (padded rows 31/32 and 63/64)."""
    src = np.array([31, 32, 63, 64, 31][:ns], np.int32) - 12
    rcv = np.array([32, 31, 64, 63, 32][:ns], np.int32) - 12
    src_x = np.linspace(4, 171, ns).astype(np.int32)
    return tuple(torch.as_tensor(a, device=dev) for a in (
        src, src_x, np.repeat(rcv[:, None], 8, axis=1),
        np.tile(np.arange(8, dtype=np.int32) * 22 + 2, (ns, 1))))


def _res_inputs(dev, ns):
    assert scalar2.resident_plan(88, 256).bands(88) == RES_BANDS
    cfg = torch_acoustic(RES_GRID, dict(chunk=20, vmax_pml=2500.0))
    vp = np.full((64, 176), 1700.0, np.float32)
    vp[32:] = 2100.0
    vp += np.random.default_rng(9).uniform(-50, 50, vp.shape).astype(
        np.float32)
    return (cfg, ricker(10.0, 180, 0.002, device=dev),
            torch.as_tensor(vp, device=dev), _edge_geom(dev, ns))


@pytest.fixture(scope="module", params=[1, 5], ids=["1_shot", "5_shots"])
def res_case(dev, request):
    return _res_inputs(dev, request.param)


def _routes(fn):
    return fn.resident_launches, fn.per_step_launches


def test_resident_b1_matches_per_step_and_plain(res_case):
    cfg, wav, vp, geom = res_case
    before = _routes(forward2)
    res = forward2(vp, wav, *geom, cfg, return_rows=True)
    per = forward2(vp, wav, *geom, cfg, return_rows=True, route="per_step")
    torch.cuda.synchronize()
    assert _routes(forward2) == (before[0] + 1, before[1] + 1)
    assert float(res.abs().max()) > 0
    # the same expression per cell: bit-equal unless FMA contraction
    # differs (then 1e-6 of max)
    assert rel_max(res, per) <= 1e-6
    ref = forward2_plain(vp, wav, *geom, cfg, return_rows=True)
    assert rel_max(res, ref) <= 1e-5


@pytest.mark.parametrize("KC", [8, 16, 32])
def test_resident_b4_matches_per_step_and_plain(res_case, KC):
    cfg, wav, vp, geom = res_case
    before = (_routes(scalar2.forward2_ckpt), _routes(scalar2.backward2))
    recs_r, ck_r = scalar2.forward2_ckpt(vp, wav, *geom, cfg, KC=KC)
    recs_s, ck_s = scalar2.forward2_ckpt(vp, wav, *geom, cfg, KC=KC,
                                         route="per_step")
    assert rel_max(recs_r, recs_s) <= 1e-6
    assert rel_max(ck_r, ck_s) <= 1e-6
    recs_p, ck_p = scalar2.forward2_ckpt_plain(vp, wav, *geom, cfg, KC=KC)
    # FMA contraction and sum order differ: 1e-5 of max over 180 steps
    assert rel_max(recs_r, recs_p) <= 1e-5
    assert rel_max(ck_r, ck_p) <= 1e-5
    rows = _l2_rows(res_case, scalar2.forward2_plain, KC)
    g_r = scalar2.backward2(vp, wav, *geom, cfg, rows, ck_p)
    g_s = scalar2.backward2(vp, wav, *geom, cfg, rows, ck_p,
                            route="per_step")
    torch.cuda.synchronize()
    assert (_routes(scalar2.forward2_ckpt), _routes(scalar2.backward2)) == (
        (before[0][0] + 1, before[0][1] + 1),
        (before[1][0] + 1, before[1][1] + 1))
    assert rel_max(g_r, g_s) <= 1e-6
    ref = scalar2.backward2_plain(vp, wav, *geom, cfg, rows, ck_p)
    # float32 rounding in another order: 1e-4 rel L2
    assert rel_l2(g_r, ref) <= 1e-4


@pytest.mark.parametrize("KC", [8, 16, 32])
def test_resident_b2_matches_per_step_and_plain(res_case, KC):
    cfg, wav, vp, geom = res_case
    g = cfg.grid
    ns = len(geom[0])
    nt_pad = -(-g.nt // KC) * KC
    gen = torch.Generator(device=vp.device).manual_seed(2)
    obs_rows = torch.zeros((ns, nt_pad, 256), device=vp.device)
    # residual signs fixed: obs > 2.5 > |yn|
    obs_rows[:, :g.nt] = torch.rand((ns, g.nt, 256), generator=gen,
                                    device=vp.device) + 2.5
    direct = forward2_plain(torch.full_like(vp, 1700.0), wav, *geom, cfg,
                            return_rows=True)
    dir_rows = torch.nn.functional.pad(0.5 * direct,
                                       (0, 0, 0, nt_pad - g.nt)).contiguous()
    args = (vp, wav, *geom, cfg, obs_rows, dir_rows)
    before = _routes(fwi_l1_loss_grad)
    lr, gr, wr = fwi_l1_loss_grad(*args, KC=KC, want_wavelet_grad=True)
    ls, gs, ws = fwi_l1_loss_grad(*args, KC=KC, want_wavelet_grad=True,
                                  route="per_step")
    torch.cuda.synchronize()
    assert _routes(fwi_l1_loss_grad) == (before[0] + 1, before[1] + 1)
    # the same sweeps' arithmetic and the same misfit kernel
    assert abs(float(lr) - float(ls)) <= 1e-6 * abs(float(ls))
    assert rel_max(gr, gs) <= 1e-6
    assert rel_max(wr, ws) <= 1e-6
    lp, gp, wp = fwi_l1_loss_grad_plain(*args, KC=KC, want_wavelet_grad=True)
    # float32 rounding in another order: loss 1e-5, gradients 1e-4 rel L2
    np.testing.assert_allclose(float(lr), float(lp), rtol=1e-5)
    assert rel_l2(gr, gp) <= 1e-4
    assert rel_l2(wr, wp) <= 1e-4


def test_grid_beyond_the_plan_takes_the_per_step_route(dev):
    # 72 x 1024 padded: 8-row bands would need 9 CTAs, 16-row ones more
    # shared memory than a block has, so B1 and B2 take the per-step
    # route by shape
    grid = dict(nz=48, nx=1000, dx=10.0, nt=40, dt=0.002, pml_width=12)
    cfg = torch_acoustic(grid, dict(chunk=20, vmax_pml=2500.0))
    assert scalar2.resident_plan(72, 1024) is None
    wav = ricker(10.0, 40, 0.002, device=dev)
    vp = torch.full((48, 1000), 1800.0, device=dev)
    geom = tuple(torch.as_tensor(a, device=dev) for a in (
        np.array([3, 3], np.int32), np.array([100, 500], np.int32),
        np.full((2, 8), 3, np.int32),
        np.tile(np.arange(8, dtype=np.int32) * 120 + 20, (2, 1))))
    before = (_routes(forward2), _routes(fwi_l1_loss_grad))
    got = forward2(vp, wav, *geom, cfg)
    rows = torch.zeros((2, 64, 1024), device=dev)
    lk, gk = fwi_l1_loss_grad(vp * 1.02, wav, *geom, cfg, rows + 2.5, rows)
    torch.cuda.synchronize()
    assert (_routes(forward2), _routes(fwi_l1_loss_grad)) == (
        (before[0][0], before[0][1] + 1), (before[1][0], before[1][1] + 1))
    assert rel_max(got, forward2_plain(vp, wav, *geom, cfg)) <= 1e-5
    lp, gp = fwi_l1_loss_grad_plain(vp * 1.02, wav, *geom, cfg, rows + 2.5,
                                    rows)
    np.testing.assert_allclose(float(lk), float(lp), rtol=1e-5)
    assert rel_l2(gk, gp) <= 1e-4
    with pytest.raises(ValueError, match="no resident plan"):
        forward2(vp, wav, *geom, cfg, route="resident")


# ---------------------------------------------------------------------------
# Kernel B9 (ops/kernel_breakdown.py): the variants of the resident forward
# sweep against their plain version, on the resident shapes above (the
# seeded field crosses the band edges, the sources sit on them)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", [v for v, _ in kernel_breakdown.VARIANTS])
def test_b9_variant_matches_plain(res_case, variant):
    cfg, wav, vp, geom = res_case
    kw = dict(kernel_breakdown.VARIANTS)[variant]
    fn = kernel_breakdown.build_variant
    before = _routes(fn)
    got = fn(vp, wav, *geom[:3], cfg, KC=16, **kw)
    again = fn(vp, wav, *geom[:3], cfg, KC=16, **kw)
    torch.cuda.synchronize()
    assert _routes(fn) == (before[0] + 2, before[1])
    plain = kernel_breakdown.build_variant_plain
    ref = plain(vp, wav, *geom[:3], cfg, KC=16, **kw)
    ref64 = plain(vp, wav, *geom[:3], cfg, KC=16, dtype=torch.float64, **kw)
    ns = len(geom[0])
    flag = {"u0": True, "um1": True, "hist": kw.get("with_rcv", False),
            "ckpt": kw.get("with_ckpt", False), "chk": True}

    def err(x, y):
        return float((x.double() - y).abs().max())

    # against the float64 run of the same discrete problem: no farther off
    # than twice the plain float32 version (plus 1e-6 of max), since FMA
    # contraction and sum order differ, and the stencil-only sweep's
    # decaying field keeps float32's error near 1e-4 of its final max
    for name, present in flag.items():
        a, b, c = getattr(got, name), getattr(ref, name), getattr(again, name)
        if not present:
            assert a is None and b is None
            continue
        b64 = getattr(ref64, name)
        assert a.shape == b.shape and torch.equal(a, c)
        assert err(a, b64) <= 2.0 * err(b, b64) + 1e-6 * float(
            b64.abs().max()), name
    assert got.hist is None or got.hist.shape == (ns, 180, 256)
    assert got.ckpt is None or got.ckpt.shape == (ns, 12, 2, 88, 256)
    assert float(got.chk.abs().sum()) == abs(float(got.chk[0, 0]))


def test_b9_grid_beyond_the_plan_raises(dev):
    """B9 has only the resident route: a grid no plan holds (72 x 1024
    padded) raises before any launch, and no launch is counted."""
    grid = dict(nz=48, nx=1000, dx=10.0, nt=40, dt=0.002, pml_width=12)
    cfg = torch_acoustic(grid, dict(chunk=20, vmax_pml=2500.0))
    vp = torch.full((48, 1000), 1800.0, device=dev)
    geom = tuple(torch.as_tensor(a, device=dev) for a in (
        np.array([3, 3], np.int32), np.array([100, 500], np.int32),
        np.full((2, 8), 3, np.int32)))
    before = _routes(kernel_breakdown.build_variant)
    with pytest.raises(ValueError, match="no resident plan"):
        kernel_breakdown.build_variant(vp, ricker(10.0, 40, 0.002, device=dev),
                                       *geom, cfg, KC=8, with_src=True)
    assert _routes(kernel_breakdown.build_variant) == before


# ---------------------------------------------------------------------------
# The resident route of B7a and B7b: B4's resident sweeps with the
# checkpoints in shot pairs and the gradient summed in pair order
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 3, 5],
                ids=["2_shots", "3_shots", "5_shots"])
def pair_case(dev, request):
    """res_case's grid and model; each shot's source on a band's edge
    row and its receivers on the neighbouring band's (an odd count is
    padded to pairs by repeating the last shot)."""
    return _res_inputs(dev, request.param)


def _pair_operands(case, rows):
    """B7's kernel operands for ``case`` (shots padded to pairs, KC 16)
    and the cotangent rows padded with the zero rows of the padded
    shot, as backward2b passes them."""
    cfg, wav, vp, geom = case
    ops = scalar2b._common(vp, wav, *geom[:3], cfg, 16, torch.float32)
    ybar = torch.nn.functional.pad(
        rows, (0, 0, 0, 0, 0, ops[3].shape[0] - rows.shape[0]))
    return ops, ybar.contiguous()


def _pair_sum_of_b4b(ops, ybar, ckpt):
    """Resident B4b's dJ/dK of each padded shot alone, from B7's
    checkpoints (put back into the shot layout), summed in pair order
    with torch adds."""
    K, dp, dm, wav, sz, sx, rr = ops
    ck = scalar2b._from_pairs(ckpt)
    one = [slice(s, s + 1) for s in range(wav.shape[0])]
    return scalar2b._sum_pairs(torch.stack([scalar2._bwd_cuda(
        K, dp, dm, wav[i], sz[i], sx[i], rr[i], ybar[i], ck[i].contiguous(),
        wav.shape[1], route="resident") for i in one]))


def test_resident_b7a_is_resident_b4a_at_kc16(pair_case):
    cfg, wav, vp, geom = pair_case
    ns = len(geom[0])
    before = _routes(scalar2b.forward2b)
    recs, ckpt = scalar2b.forward2b(vp, wav, *geom, cfg)
    torch.cuda.synchronize()
    assert _routes(scalar2b.forward2b) == (before[0] + 1, before[1])
    assert ckpt.shape[0] == -(-ns // 2) and float(recs.abs().max()) > 0
    recs4, ck4 = scalar2.forward2_ckpt(vp, wav, *geom, cfg, KC=16,
                                       route="resident")
    # the same kernel; only the checkpoint address differs
    assert torch.equal(recs, recs4)
    shots = scalar2b._from_pairs(ckpt)
    assert torch.equal(shots[:ns], ck4)
    if ns % 2:   # the padded shot repeats the last one
        assert torch.equal(shots[ns], ck4[-1])


def test_resident_b7b_is_the_pair_sum_of_resident_b4b(pair_case):
    cfg, wav, vp, geom = pair_case
    g = cfg.grid
    rows = _l2_rows(pair_case, scalar2.forward2_plain, 16)
    _, ckpt = scalar2b.forward2b(vp, wav, *geom, cfg)
    ops, ybar = _pair_operands(pair_case, rows)
    gk = scalar2b._bwd_cuda(*ops, ybar, ckpt, route="resident")
    assert float(gk.abs().max()) > 0
    assert torch.equal(gk, _pair_sum_of_b4b(ops, ybar, ckpt))
    # the wrapper: that dJ/dK through the chain rule
    got = scalar2b.backward2b(vp, wav, *geom, cfg, rows, ckpt)
    assert torch.equal(got, scalar2._vp_grad(gk, vp, cfg,
                                             (g.dt / g.dx) ** 2))


def test_resident_b7_matches_per_step_cross_routes_and_plain(pair_case):
    cfg, wav, vp, geom = pair_case
    fwd, bwd = scalar2b.forward2b, scalar2b.backward2b
    before = (_routes(fwd), _routes(bwd))
    ck = {}
    recs_r, ck["resident"] = fwd(vp, wav, *geom, cfg, route="resident")
    recs_s, ck["per_step"] = fwd(vp, wav, *geom, cfg, route="per_step")
    assert rel_max(recs_r, recs_s) <= 1e-6
    assert rel_max(ck["resident"], ck["per_step"]) <= 1e-6
    rows = _l2_rows(pair_case, scalar2.forward2_plain, 16)
    # each backward route from each forward route's checkpoints
    grads = {(f, b): bwd(vp, wav, *geom, cfg, rows, ck[f], route=b)
             for f in ck for b in ("resident", "per_step")}
    torch.cuda.synchronize()
    assert (_routes(fwd), _routes(bwd)) == (
        (before[0][0] + 1, before[0][1] + 1),
        (before[1][0] + 2, before[1][1] + 2))
    ref_r = grads[("resident", "resident")]
    for key, got in grads.items():
        assert rel_max(got, ref_r) <= 1e-6, key
    recs_p, ck_p = scalar2b.forward2b_plain(vp, wav, *geom, cfg)
    # FMA contraction and sum order differ: 1e-5 of max over 180 steps
    assert rel_max(recs_r, recs_p) <= 1e-5
    assert rel_max(ck["resident"], ck_p) <= 1e-5
    got = bwd(vp, wav, *geom, cfg, rows, ck_p, route="resident")
    ref = scalar2b.backward2b_plain(vp, wav, *geom, cfg, rows, ck_p)
    # float32 rounding in another order: 1e-4 rel L2
    assert rel_l2(got, ref) <= 1e-4


def test_acoustic_pallas2b_launches_resident_b7(pair_case):
    cfg, wav, vp, geom = pair_case
    fns = (scalar2b.forward2b, scalar2b.backward2b)
    before = [_routes(f) for f in fns]
    v = vp.clone().requires_grad_(True)
    scalar2b.acoustic_pallas2b(v, wav, *geom, cfg).square().sum().backward()
    torch.cuda.synchronize()
    assert [_routes(f) for f in fns] == [(r + 1, s) for r, s in before]
    assert bool(torch.isfinite(v.grad).all())


def test_b7_grid_beyond_the_plan_takes_the_per_step_route(dev):
    # 72 x 1024 padded, as test_grid_beyond_the_plan_takes_the_per_step_route
    grid = dict(nz=48, nx=1000, dx=10.0, nt=40, dt=0.002, pml_width=12)
    cfg = torch_acoustic(grid, dict(chunk=20, vmax_pml=2500.0))
    wav = ricker(10.0, 40, 0.002, device=dev)
    vp = torch.full((48, 1000), 1800.0, device=dev)
    geom = tuple(torch.as_tensor(a, device=dev) for a in (
        np.array([3, 3, 5], np.int32), np.array([100, 500, 900], np.int32),
        np.full((3, 8), 3, np.int32),
        np.tile(np.arange(8, dtype=np.int32) * 120 + 20, (3, 1))))
    fns = (scalar2b.forward2b, scalar2b.backward2b)
    before = [_routes(f) for f in fns]
    recs, ckpt = scalar2b.forward2b(vp, wav, *geom, cfg)
    rows = scalar2.scatter_rows(recs, geom[3], nt=40, nx=1000, pml_width=12,
                                KC=16)
    got = scalar2b.backward2b(vp, wav, *geom, cfg, rows, ckpt)
    torch.cuda.synchronize()
    assert [_routes(f) for f in fns] == [(r, s + 1) for r, s in before]
    recs_p, ck_p = scalar2b.forward2b_plain(vp, wav, *geom, cfg)
    assert rel_max(recs, recs_p) <= 1e-5
    ref = scalar2b.backward2b_plain(vp, wav, *geom, cfg, rows, ck_p)
    assert rel_l2(got, ref) <= 1e-4
    with pytest.raises(ValueError, match="no resident plan"):
        scalar2b.forward2b(vp, wav, *geom, cfg, route="resident")


# ---------------------------------------------------------------------------
# B3's resident route (one thread-block cluster per shot)
# ---------------------------------------------------------------------------

def _el_edge_geom(dev, ns, top, rows=8):
    """``ns`` shots on an elastic grid (top pad ``top``) cut into bands
    of ``rows`` rows, each with its source on one band's edge row and its
    receivers on the neighbouring band's (padded rows 15/16, 23/24, 31/32
    for bands of 8)."""
    e = [k * rows - 1 for k in (2, 3, 4)]
    src = np.array([e[0], e[0] + 1, e[1], e[1] + 1, e[2]][:ns],
                   np.int32) - top
    rcv = np.array([e[0] + 1, e[0], e[1] + 1, e[1], e[2] + 1][:ns],
                   np.int32) - top
    src_x = np.linspace(3, 44, ns).astype(np.int32)
    return tuple(torch.as_tensor(a, device=dev) for a in (
        src, src_x, np.repeat(rcv[:, None], 8, axis=1),
        np.tile(np.arange(8, dtype=np.int32) * 6 + 2, (ns, 1))))


# (free surface, shots, rows of the physical grid, bands, band rows,
# layout): the elastic case's grid in 6 or 7 bands of 8 rows (layout 0),
# and taller ones of 144 and 192 rows in kernel layout, in 16 bands of 9
# and of 12 rows (layout 1, seam_elastic's and real_data's bands)
EL_RES_CASES = [(True, 1, 36, 6, 8, 0), (True, 5, 36, 6, 8, 0),
                (False, 1, 36, 7, 8, 0), (False, 5, 36, 7, 8, 0),
                (True, 5, 134, 16, 9, 1), (False, 5, 176, 16, 12, 1)]
EL_RES_IDS = ["free_surface-1_shot", "free_surface-5_shots",
              "absorbing_top-1_shot", "absorbing_top-5_shots",
              "free_surface-16x9", "absorbing_top-16x12"]


@pytest.fixture(scope="module", params=EL_RES_CASES, ids=EL_RES_IDS)
def el_res_case(dev, request):
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        make_elastic_model, make_marmousi_like)
    free_surface, ns, nz, cluster, rows, layout = request.param
    grid, cfg, wargs, med, _ = elastic_case(free_surface=free_surface)
    # KC 8 and 16 both pad to 64 steps
    cfg = torch_elastic(dict(grid, nz=nz, nt=60), cfg)
    if nz != grid["nz"]:
        med = make_elastic_model(make_marmousi_like(nz, 48, seed=0,
                                                    water_rows=4),
                                 water_rows=4)
    top = 2 if free_surface else 8
    nz8, nx128 = ef._layout(cfg)[4:]
    plan = ef.elastic_resident_plan(nz8, nx128)
    assert (plan.cluster, plan.band_rows, plan.layout) == (cluster, rows,
                                                           layout)
    med = tuple(torch.as_tensor(a, device=dev) for a in med)
    return (cfg, ricker(wargs[0], 60, wargs[2], device=dev), med,
            _el_edge_geom(dev, ns, top, rows))


@pytest.mark.parametrize("KC", [8, 16])
@pytest.mark.parametrize("misfit", ["l2", "tnl1"])
def test_resident_b3_matches_per_step_and_plain(el_res_case, misfit, KC):
    cfg, wav, med, geom = el_res_case
    obs = ef.simulate_elastic_ring_plain(*med, wav, *geom, cfg)
    if misfit == "tnl1":
        obs = tuple(trace_normalize(o) for o in obs)
    rows = [ef.scatter_rows_el(o, geom[3], cfg, KC=KC) for o in obs]
    meds = ef.prep_medium(med[0] * 0.9, med[1], med[2], cfg)
    damp = ef.prep_damp(cfg, wav.device)
    args = (meds, damp, wav, *geom, cfg, *rows)
    fn = ef.fused_elastic_loss_grad_meds
    before = _routes(fn)
    lr, gr = fn(*args, KC=KC, misfit=misfit)
    ls, gs = fn(*args, KC=KC, misfit=misfit, route="per_step")
    torch.cuda.synchronize()
    assert _routes(fn) == (before[0] + 1, before[1] + 1)
    # the same per-cell functions on both routes: the same bits
    assert torch.equal(lr, ls)
    assert all(torch.equal(a, b) for a, b in zip(gr, gs))
    assert float(lr) > 0 and all(float(a.abs().max()) > 0 for a in gr)
    lp, gp = ef.fused_elastic_loss_grad_meds_plain(*args, KC=KC,
                                                   misfit=misfit)
    # float32 rounding in another order: loss 1e-5, gradients 1e-4 rel L2
    np.testing.assert_allclose(float(lr), float(lp), rtol=1e-5)
    for a, b in zip(gr, gp):
        assert rel_l2(a, b) <= 1e-4


@pytest.mark.parametrize("misfit", ["l2", "tnl1"])
def test_b3_layout_1_band_of_8_matches_layout_0(el_res_case, misfit):
    """Layout 1's instance for bands of 8 rows (the media through L1, the
    gradients in shared memory), which no planner picks, against layout
    0's on the same grid: the same bits."""
    cfg, wav, med, geom = el_res_case
    nz8, nx128 = ef._layout(cfg)[4:]
    plan = ef.elastic_resident_plan(nz8, nx128)
    if plan.layout != 0:
        pytest.skip("layout 1 is this grid's own plan")
    tall = dataclasses.replace(plan, layout=1, smem_bytes=ef.el_smem(
        8, nx128, 1, reverse=True))
    obs = ef.simulate_elastic_ring_plain(*med, wav, *geom, cfg)
    if misfit == "tnl1":
        obs = tuple(trace_normalize(o) for o in obs)
    rows = [ef.scatter_rows_el(o, geom[3], cfg, KC=8) for o in obs]
    meds = ef.prep_medium(med[0] * 0.9, med[1], med[2], cfg)
    damp = ef.prep_damp(cfg, wav.device)
    args = (meds, damp, wav, *geom, cfg, *rows, 8, misfit)
    fn = ef.fused_elastic_loss_grad_meds
    before = _routes(fn)
    l0, g0 = ef._loss_grad_meds(functools.partial(
        ef._loss_gmeds_cuda, route="resident"), *args)
    l1, g1 = ef._loss_grad_meds(functools.partial(
        ef._loss_gmeds_cuda, route="resident", plan=tall), *args)
    torch.cuda.synchronize()
    assert _routes(fn) == (before[0] + 2, before[1])
    assert torch.equal(l0, l1) and float(l0) > 0
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    with pytest.raises(ValueError, match="route='resident'"):
        ef._loss_grad_meds(functools.partial(
            ef._loss_gmeds_cuda, route="per_step", plan=tall), *args)


def test_b3_grid_beyond_the_plan_takes_the_per_step_route(dev):
    # 46 x 416 padded to 48 x 512: wider than the plan's 384 threads
    grid = dict(nz=36, nx=400, dx=15.0, nt=24, dt=0.0015, pml_width=8,
                free_surface=True)
    cfg = torch_elastic(grid, dict(chunk=16, vmax_pml=4000.0))
    assert ef._layout(cfg)[4:] == (48, 512)
    assert ef.elastic_resident_plan(48, 512) is None
    rng = np.random.default_rng(3)
    med = tuple(torch.as_tensor(
        (v * (1.0 + 0.02 * rng.standard_normal((36, 400)))).astype(
            np.float32), device=dev) for v in (2000.0, 1100.0, 2100.0))
    geom = tuple(torch.as_tensor(a, device=dev) for a in (
        np.array([5, 5], np.int32), np.array([60, 300], np.int32),
        np.full((2, 8), 5, np.int32),
        np.tile(np.arange(8, dtype=np.int32) * 48 + 10, (2, 1))))
    wav = ricker(12.0, 24, 0.0015, device=dev)
    rows = [ef.scatter_rows_el(o, geom[3], cfg, KC=8)
            for o in ef.simulate_elastic_ring_plain(*med, wav, *geom, cfg)]
    meds = ef.prep_medium(med[0] * 0.95, med[1], med[2], cfg)
    damp = ef.prep_damp(cfg, dev)
    args = (meds, damp, wav, *geom, cfg, *rows)
    fn = ef.fused_elastic_loss_grad_meds
    before = _routes(fn)
    lk, gk = fn(*args, KC=8)
    torch.cuda.synchronize()
    assert _routes(fn) == (before[0], before[1] + 1)
    lp, gp = ef.fused_elastic_loss_grad_meds_plain(*args, KC=8)
    np.testing.assert_allclose(float(lk), float(lp), rtol=1e-5)
    for a, b in zip(gk, gp):
        assert rel_l2(a, b) <= 1e-4
    with pytest.raises(ValueError, match="no resident plan"):
        fn(*args, KC=8, route="resident")


# ---------------------------------------------------------------------------
# B5's and B6's resident route (one thread-block cluster per shot)
# ---------------------------------------------------------------------------

def test_resident_b5_b6_match_per_step_and_plain(res_case):
    cfg, wav, vp, geom = res_case
    g = cfg.grid
    plan = kernels.acoustic_resident_plan(88, 256)
    assert plan.bands(88) == RES_BANDS
    fwd = kernels.acoustic_forward_pallas
    bwd = adjoint.acoustic_pallas_backward
    before = (_routes(fwd), _routes(bwd))
    res = fwd(vp, wav, *geom, cfg)
    per = fwd(vp, wav, *geom, cfg, route="per_step")
    # the same rounded per-cell functions on both routes: the same bits
    assert torch.equal(res, per) and float(res.abs().max()) > 0
    # FMA contraction and sum order differ: 1e-5 of max over 180 steps
    assert rel_max(res, kernels.acoustic_forward_pallas_plain(
        vp, wav, *geom, cfg)) <= 1e-5
    # B6's forward sweep: the checkpoints of both routes
    kap, damp, _, amp, sz, sx, rrow = kernels.operands(
        vp, wav, *geom[:3], cfg, nt_pad=192, gain="b6")
    a = g.dt / g.dx
    ck_r = adjoint._checkpoints_cuda(kap, damp, amp, sz, sx, rrow, a,
                                     "resident")
    ck_s = adjoint._checkpoints_cuda(kap, damp, amp, sz, sx, rrow, a,
                                     "per_step")
    assert torch.equal(ck_r, ck_s) and float(ck_r.abs().max()) > 0
    rows = _l2_rows(res_case, kernels.acoustic_forward_pallas_plain, 16)
    g_r = bwd(vp, wav, *geom, cfg, rows)
    g_s = bwd(vp, wav, *geom, cfg, rows, route="per_step")
    torch.cuda.synchronize()
    assert (_routes(fwd), _routes(bwd)) == (
        (before[0][0] + 1, before[0][1] + 1),
        (before[1][0] + 1, before[1][1] + 1))
    assert torch.equal(g_r, g_s) and float(g_r.abs().max()) > 0
    ref = adjoint.acoustic_pallas_backward_plain(vp, wav, *geom, cfg, rows)
    # float32 rounding in another order: 1e-4 rel L2
    assert rel_l2(g_r, ref) <= 1e-4


def test_acoustic_pallas_launches_resident_b5_b6(res_case):
    cfg, wav, vp, geom = res_case
    fns = (kernels.acoustic_forward_pallas, adjoint.acoustic_pallas_backward)
    before = [_routes(f) for f in fns]
    v = vp.clone().requires_grad_(True)
    adjoint.acoustic_pallas(v, wav, *geom, cfg).square().sum().backward()
    torch.cuda.synchronize()
    assert [_routes(f) for f in fns] == [(r + 1, p) for r, p in before]
    assert bool(torch.isfinite(v.grad).all()) and float(
        v.grad.abs().max()) > 0


def test_b5_b6_grid_beyond_the_plan_takes_the_per_step_route(dev):
    # 72 x 1024 padded: 8-row bands would need 9 CTAs, so B5 and B6 take
    # the per-step route by shape
    grid = dict(nz=48, nx=1000, dx=10.0, nt=40, dt=0.002, pml_width=12)
    cfg = torch_acoustic(grid, dict(chunk=20, vmax_pml=2500.0))
    assert kernels.acoustic_resident_plan(72, 1024) is None
    wav = ricker(10.0, 40, 0.002, device=dev)
    vp = torch.full((48, 1000), 1800.0, device=dev)
    geom = tuple(torch.as_tensor(a, device=dev) for a in (
        np.array([3, 3], np.int32), np.array([100, 500], np.int32),
        np.full((2, 8), 3, np.int32),
        np.tile(np.arange(8, dtype=np.int32) * 120 + 20, (2, 1))))
    fwd = kernels.acoustic_forward_pallas
    bwd = adjoint.acoustic_pallas_backward
    before = (_routes(fwd), _routes(bwd))
    got = fwd(vp, wav, *geom, cfg)
    rows = _l2_rows((cfg, wav, vp, geom),
                    kernels.acoustic_forward_pallas_plain, 16)
    gk = bwd(vp, wav, *geom, cfg, rows)
    torch.cuda.synchronize()
    assert (_routes(fwd), _routes(bwd)) == (
        (before[0][0], before[0][1] + 1), (before[1][0], before[1][1] + 1))
    assert rel_max(got, kernels.acoustic_forward_pallas_plain(
        vp, wav, *geom, cfg)) <= 1e-5
    assert rel_l2(gk, adjoint.acoustic_pallas_backward_plain(
        vp, wav, *geom, cfg, rows)) <= 1e-4
    for fn, args in ((fwd, ()), (bwd, (rows,))):
        with pytest.raises(ValueError, match="no resident plan"):
            fn(vp, wav, *geom, cfg, *args, route="resident")


# ---------------------------------------------------------------------------
# The ring forward's and B8's resident route (B3's forward sweep alone,
# bands of 8 or 9 rows)
# ---------------------------------------------------------------------------

# (free surface, rows of the physical grid): 6 x 8 and 7 x 8 bands on the
# elastic case's grid, 16 x 9 on a taller one (144 x 128 in kernel layout)
# and 16 x 12 on one taller still (192 x 128, layout 1)
FWD_CASES = [(True, 36, 6, 8), (False, 36, 7, 8), (True, 134, 16, 9),
             (False, 128, 16, 9), (True, 182, 16, 12), (False, 176, 16, 12)]
FWD_IDS = ["free_surface-6x8", "absorbing_top-7x8", "free_surface-16x9",
           "absorbing_top-16x9", "free_surface-16x12", "absorbing_top-16x12"]


def _fwd_case(dev, free_surface, nz, cluster, rows):
    """60 steps of 5 shots on an nz x 48 grid whose kernel layout the
    forward plan cuts into ``cluster`` bands of ``rows`` rows, each shot
    with its source on one band's edge row and its receivers on the
    neighbouring band's."""
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        make_elastic_model, make_marmousi_like)
    grid, cfg, wargs, _, _ = elastic_case(free_surface=free_surface)
    cfg = torch_elastic(dict(grid, nz=nz, nt=60), cfg)
    nz8, nx128 = ef._layout(cfg)[4:]
    plan = ef.elastic_forward_plan(nz8, nx128)
    assert (plan.cluster, plan.band_rows) == (cluster, rows)
    med = tuple(torch.as_tensor(a, device=dev) for a in make_elastic_model(
        make_marmousi_like(nz, 48, seed=0, water_rows=4), water_rows=4))
    top = 2 if free_surface else 8
    edges = [k * rows - 1 for k in (2, 3, 4)]
    src = np.array([edges[0], edges[0] + 1, edges[1], edges[1] + 1,
                    edges[2]], np.int32)
    rcv = np.array([edges[0] + 1, edges[0], edges[1] + 1, edges[1],
                    edges[2] + 1], np.int32)
    geom = tuple(torch.as_tensor(a, device=dev) for a in (
        src - top, np.linspace(3, 44, 5).astype(np.int32),
        np.repeat(rcv[:, None] - top, 8, axis=1),
        np.tile(np.arange(8, dtype=np.int32) * 6 + 2, (5, 1))))
    return cfg, ricker(wargs[0], 60, wargs[2], device=dev), med, geom


@pytest.mark.parametrize("free_surface,nz,cluster,rows", FWD_CASES,
                         ids=FWD_IDS)
def test_resident_ring_forward_matches_per_step_and_plain(
        dev, free_surface, nz, cluster, rows):
    cfg, wav, med, geom = _fwd_case(dev, free_surface, nz, cluster, rows)
    fn = ef.simulate_elastic_ring
    before = _routes(fn)
    res = fn(*med, wav, *geom, cfg)
    per = fn(*med, wav, *geom, cfg, route="per_step")
    torch.cuda.synchronize()
    assert _routes(fn) == (before[0] + 1, before[1] + 1)
    # the same per-cell functions on both routes: the same bits
    assert all(torch.equal(a, b) for a, b in zip(res, per))
    ref = ef.simulate_elastic_ring_plain(*med, wav, *geom, cfg)
    for a, b in zip(res, ref):
        assert float(a.abs().max()) > 0
        # FMA contraction and sum order differ: 1e-5 of max over 60 steps
        assert rel_max(a, b) <= 1e-5


@pytest.mark.parametrize("nz,cluster,rows", [(36, 7, 8), (128, 16, 9),
                                             (176, 16, 12)],
                         ids=["7x8", "16x9", "16x12"])
def test_resident_b8_matches_per_step_ring_and_plain(dev, nz, cluster,
                                                     rows):
    cfg, wav, med, geom = _fwd_case(dev, False, nz, cluster, rows)
    b8 = elastic_fwd.elastic_forward_pallas
    before = _routes(b8)
    res = b8(*med, wav, *geom, cfg)
    per = b8(*med, wav, *geom, cfg, route="per_step")
    ring = ef.simulate_elastic_ring(*med, wav, *geom, cfg)
    torch.cuda.synchronize()
    assert _routes(b8) == (before[0] + 1, before[1] + 1)
    # the ring forward's resident instance with no free-surface row, and
    # its per-step kernels
    assert all(torch.equal(a, b) for a, b in zip(res, ring))
    assert all(torch.equal(a, b) for a, b in zip(res, per))
    ref = elastic_fwd.elastic_forward_pallas_plain(*med, wav, *geom, cfg)
    for a, b in zip(res, ref):
        assert rel_max(a, b) <= 1e-5


@pytest.mark.parametrize("misfit", ["l2", "tnl1"])
def test_seam_rows_b3_per_step_and_ring_forward(dev, misfit):
    """seam_elastic's layout at a small width: a free surface and 144
    rows in kernel layout (134 + 2 ring rows + PML 8), which B3's plan
    cuts into 9-row bands of layout 1 and the forward plan into 9-row
    bands of layout 0; sources on row 6 (in band 0), receivers on row 23
    (band 2).  B3 on both routes, the same bits."""
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        make_elastic_model, make_marmousi_like)
    grid, cfg, wargs, _, _ = elastic_case(free_surface=True)
    cfg = torch_elastic(dict(grid, nz=134, nt=60), cfg)
    nz8, nx128 = ef._layout(cfg)[4:]
    assert (nz8, nx128) == (144, 128)
    assert ef.elastic_resident_plan(nz8, nx128).layout == 1
    assert ef.elastic_forward_plan(nz8, nx128).band_rows == 9
    med = tuple(torch.as_tensor(a, device=dev) for a in make_elastic_model(
        make_marmousi_like(134, 48, seed=0, water_rows=4), water_rows=4))
    ns = 3
    geom = tuple(torch.as_tensor(a, device=dev) for a in (
        np.full(ns, 6, np.int32), np.array([4, 24, 43], np.int32),
        np.full((ns, 8), 23, np.int32),
        np.tile(np.arange(8, dtype=np.int32) * 6 + 2, (ns, 1))))
    wav = ricker(wargs[0], 60, wargs[2], device=dev)
    ring = ef.simulate_elastic_ring
    before = _routes(ring)
    obs = ring(*med, wav, *geom, cfg)
    per = ring(*med, wav, *geom, cfg, route="per_step")
    torch.cuda.synchronize()
    assert _routes(ring) == (before[0] + 1, before[1] + 1)
    assert all(torch.equal(a, b) for a, b in zip(obs, per))
    for a, b in zip(obs, ef.simulate_elastic_ring_plain(*med, wav, *geom,
                                                         cfg)):
        assert float(a.abs().max()) > 0
        assert rel_max(a, b) <= 1e-5
    if misfit == "tnl1":
        obs = tuple(trace_normalize(o) for o in obs)
    rows = [ef.scatter_rows_el(o, geom[3], cfg, KC=8) for o in obs]
    damp = ef.prep_damp(cfg, dev)
    fn = ef.fused_elastic_loss_grad_meds
    before = _routes(fn)
    l_true, _ = fn(ef.prep_medium(*med, cfg), damp, wav, *geom, cfg, *rows,
                   KC=8, misfit=misfit)
    args = (ef.prep_medium(med[0] * 0.95, med[1], med[2], cfg), damp, wav,
            *geom, cfg, *rows)
    lk, gk = fn(*args, KC=8, misfit=misfit)
    ls, gs = fn(*args, KC=8, misfit=misfit, route="per_step")
    torch.cuda.synchronize()
    assert _routes(fn) == (before[0] + 2, before[1] + 1)
    assert torch.equal(lk, ls)
    assert all(torch.equal(a, b) for a, b in zip(gk, gs))
    # the ring forward's traces are B3's forward: zero misfit at the truth
    assert float(l_true) <= 1e-9
    lp, gp = ef.fused_elastic_loss_grad_meds_plain(*args, KC=8,
                                                   misfit=misfit)
    np.testing.assert_allclose(float(lk), float(lp), rtol=1e-5)
    for a, b in zip(gk, gp):
        assert float(a.abs().max()) > 0
        assert rel_l2(a, b) <= 1e-4


def test_forward_grid_beyond_the_plan_takes_the_other_routes(dev):
    # 48 x 512 in kernel layout: wider than the plan's 384 threads
    grid = dict(nz=32, nx=400, dx=15.0, nt=24, dt=0.0015, pml_width=8,
                free_surface=False)
    cfg = torch_elastic(grid, dict(chunk=16, vmax_pml=4000.0))
    assert ef._layout(cfg)[4:] == (48, 512)
    assert ef.elastic_forward_plan(48, 512) is None
    rng = np.random.default_rng(3)
    med = tuple(torch.as_tensor(
        (v * (1.0 + 0.02 * rng.standard_normal((32, 400)))).astype(
            np.float32), device=dev) for v in (2000.0, 1100.0, 2100.0))
    geom = tuple(torch.as_tensor(a, device=dev) for a in (
        np.array([5, 5], np.int32), np.array([60, 300], np.int32),
        np.full((2, 8), 5, np.int32),
        np.tile(np.arange(8, dtype=np.int32) * 48 + 10, (2, 1))))
    wav = ricker(12.0, 24, 0.0015, device=dev)
    ring, b8 = ef.simulate_elastic_ring, elastic_fwd.elastic_forward_pallas
    before = (_routes(ring), _routes(b8))
    got = ring(*med, wav, *geom, cfg)
    got8 = b8(*med, wav, *geom, cfg)
    torch.cuda.synchronize()
    assert (_routes(ring), _routes(b8)) == (
        (before[0][0], before[0][1] + 1), (before[1][0], before[1][1] + 1))
    ref = ef.simulate_elastic_ring_plain(*med, wav, *geom, cfg)
    for a, b, c in zip(got, got8, ref):
        assert rel_max(a, c) <= 1e-5
        assert rel_max(b, c) <= 1e-5
    for fn in (ring, b8):
        with pytest.raises(ValueError, match="no resident plan"):
            fn(*med, wav, *geom, cfg, route="resident")


@pytest.mark.parametrize("scheme", ["fast", "pml"])
def test_elastic_autograd_on_card_matches_cpu(el_case, scheme, monkeypatch):
    """The plain elastic propagators under autograd on the card, where
    each chunk of the scan's forward and backward is replayed as a CUDA
    graph (captured once a scan), against the same on the CPU: the
    traces and the trace-normalized L2 gradient w.r.t. vp and vs, with
    duplicate receiver cells."""
    from physicsbasedfwi2_tpu_torch.ops import scan_utils
    from physicsbasedfwi2_tpu_torch.ops.elastic import simulate_elastic
    from physicsbasedfwi2_tpu_torch.ops.elastic_fast import (
        simulate_elastic_fast)
    sim = simulate_elastic_fast if scheme == "fast" else simulate_elastic
    cfg, wav, med, geom = el_case
    geom = geom[:3] + (torch.cat([geom[3][:, :5], geom[3][:, :5]], 1),)
    captures = []
    capture = scan_utils._ChunkGraphs._capture
    monkeypatch.setattr(scan_utils._ChunkGraphs, "_capture", staticmethod(
        lambda fn: captures.append(1) or capture(fn)))

    def run(device):
        m = [a.to(device) for a in med]
        g = [a.to(device) for a in geom]
        w = wav.to(device)
        with torch.no_grad():
            obs = sim(m[0] * 1.02, m[1] * 0.98, m[2], w, *g, cfg)
        vp, vs = (a.clone().requires_grad_(True) for a in m[:2])
        pred = sim(vp, vs, m[2], w, *g, cfg)
        loss = sum(torch.mean((trace_normalize(p) - trace_normalize(o)) ** 2)
                   for p, o in zip(pred, obs))
        gp, gs = torch.autograd.grad(loss, (vp, vs))
        return [x.detach().cpu() for x in (*pred, loss, gp, gs)]

    got = run(med[0].device)
    torch.cuda.synchronize()
    # the obs forward (no grad), and the forward and backward of the
    # value and gradient: one capture each
    assert len(captures) == 3
    ref = run("cpu")
    for a, b in zip(got[:2], ref[:2]):
        assert rel_max(a, b) <= 1e-5
    assert abs(float(got[2]) - float(ref[2])) <= 1e-5 * float(ref[2])
    for a, b in zip(got[3:], ref[3:]):
        assert rel_l2(a, b) <= 1e-4


def test_encoded_autograd_on_card_matches_cpu(case, monkeypatch):
    """The super-shot propagator (``ops/encoding.py``) under autograd on
    the card, each chunk replayed as a CUDA graph, against the same on the
    CPU: the traces, the L2 loss and dJ/dvp of an encoded gradient."""
    from physicsbasedfwi2_tpu_torch.ops import encoding, scan_utils
    cfg, wav, vp, geom = case
    captures = []
    capture = scan_utils._ChunkGraphs._capture
    monkeypatch.setattr(scan_utils._ChunkGraphs, "_capture", staticmethod(
        lambda fn: captures.append(1) or capture(fn)))
    groups = torch.tensor([[1], [0]])
    pol = torch.tensor([[1.0], [-1.0]])

    def run(device):
        v = vp.to(device)
        g = [a.to(device) for a in geom]
        w = wav.to(device)
        with torch.no_grad():
            # each shot alone: the per-shot observed gathers
            obs = encoding.simulate_acoustic_encoded(
                v * 1.03, w, g[0][:, None], g[1][:, None],
                torch.ones((2, 1), device=device), g[2], g[3], cfg)
        loss, grad = encoding.encoded_fwi_gradient(
            v, obs, w, *g, cfg, 2, groups=groups, pol=pol)
        return [x.detach().cpu() for x in (obs, loss, grad)]

    got = run(vp.device)
    torch.cuda.synchronize()
    # the obs forward (no grad), then the forward and backward of the
    # gradient: one capture each
    assert len(captures) == 3
    ref = run("cpu")
    assert rel_max(got[0], ref[0]) <= 1e-5
    assert abs(float(got[1]) - float(ref[1])) <= 1e-5 * float(ref[1])
    assert rel_l2(got[2], ref[2]) <= 1e-4


# every wrapper with a launch counter: the engines of the last slice run
# plain PyTorch (the JAX package's XLA paths) and launch none of them
KERNELS = (scalar2.forward2, fwi_l1_loss_grad, ef.fused_elastic_loss_grad_meds,
           ef.simulate_elastic_ring, scalar2.forward2_ckpt, scalar2.backward2,
           kernels.acoustic_forward_pallas, adjoint.acoustic_pallas_backward,
           scalar2b.forward2b, scalar2b.backward2b,
           elastic_fwd.elastic_forward_pallas)
SMALL = dict(nz=40, nx=48, nt=200, dt=0.001, num_shots=4, num_receivers=24,
             filters=(4, 8, 16), chunk=25, water_rows=6, pml_width=12,
             validate_on_twin=False)


@pytest.mark.parametrize("name,over", [
    ("latent_inversion", {}),
    ("classic_fwi_acoustic", {}),
    ("classic_fwi_elastic", {"dt": 0.0015, "shots_per_iter": 2,
                             "water_rows": 4, "lstart": 0}),
    ("marmousi_impedance", {}),
    ("marmousi_acoustic_encoded", {"encoded_shots": 2}),
    ("marmousi_acoustic", {"engine": "acoustic_dip_multi"}),
], ids=["latent", "classic_acoustic", "classic_elastic", "impedance",
        "encoded", "multi"])
def test_new_engines_run_on_the_card_by_default(dev, tmp_path, name, over):
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import create_engine
    cfg = get_workload(name, **{**SMALL, **over}, save_dir=str(tmp_path))
    scalar2.reset_launches(*KERNELS)
    engine = create_engine(cfg)  # no device: the first card
    assert engine.device == dev
    assert all(p.device == dev for p in engine.weights.parameters())
    rec = engine.optimize_parameters(1)
    torch.cuda.synchronize()
    assert all(np.isfinite(v) for v in rec.values())
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)


@pytest.mark.parametrize("out_shape", [None, (151, 200)])
def test_resize_backward_repeats_on_card(dev, out_shape):
    """The generators' resizes on the card: forward equal to
    F.interpolate, backward repeated bit for bit and within 1e-6 of the
    CPU's."""
    import torch.nn.functional as F
    from physicsbasedfwi2_tpu_torch.models.blocks import (
        fit_to_shape, resize_2x)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 38, 50, generator=gen)
    fn = resize_2x if out_shape is None else (
        lambda a: fit_to_shape(a, out_shape))
    g = torch.randn(fn(x).shape, generator=gen)
    grads = []
    for _ in range(2):
        xc = x.to(dev).requires_grad_()
        out = fn(xc)
        (gc,) = torch.autograd.grad(out, xc, g.to(dev))
        grads.append(gc)
    if out_shape is None:
        assert torch.equal(out, F.interpolate(
            x.to(dev), scale_factor=2, mode="bilinear", align_corners=False))
    assert torch.equal(grads[0], grads[1])
    xr = x.clone().requires_grad_()
    (gr,) = torch.autograd.grad(fn(xr), xr, g)
    assert rel_max(grads[0].cpu(), gr) <= 1e-6


def test_simulate_acoustic_replays_graphs_without_autograd(case,
                                                           monkeypatch):
    """``simulate_acoustic`` without autograd on the card runs the
    explicit-parameter scan, one CUDA-graph capture a scan, to the bit of
    the closure scan's loop on the card, and within 1e-5 of the CPU; under
    autograd it stays on the closure scan (no capture)."""
    from physicsbasedfwi2_tpu_torch.ops import acoustic, scan_utils
    cfg, wav, vp, geom = case
    captures = []
    capture = scan_utils._ChunkGraphs._capture
    monkeypatch.setattr(scan_utils._ChunkGraphs, "_capture", staticmethod(
        lambda fn: captures.append(1) or capture(fn)))
    with torch.no_grad():
        got = acoustic.simulate_acoustic(vp, wav, *geom, cfg)
        loop = acoustic._simulate(vp, wav, *geom, cfg, explicit=False)
    torch.cuda.synchronize()
    assert len(captures) == 1
    assert torch.equal(got, loop)
    ref = acoustic.simulate_acoustic(vp.cpu(), wav.cpu(),
                                     *(a.cpu() for a in geom), cfg)
    assert rel_max(got, ref) <= 1e-5
    v = vp.clone().requires_grad_()
    (acoustic.simulate_acoustic(v, wav, *geom, cfg) ** 2).sum().backward()
    assert len(captures) == 1 and torch.isfinite(v.grad).all()


def test_landscape_hvp_on_card_matches_cpu(dev):
    """The composite HVP through the ring forward's plain version and
    through ``simulate_acoustic`` on the card against the same on the
    CPU (small grid, a tiny decoder)."""
    from physicsbasedfwi2_tpu_torch.landscape import composite_hvp
    from physicsbasedfwi2_tpu_torch.ops import simulate_acoustic
    grid, cfg, wargs, vp, geom = acoustic_case()
    grid = dict(grid, nt=90)
    acfg = torch_acoustic(grid, cfg)
    egrid, ecfg, ewargs, fields, egeom = elastic_case()
    el = torch_elastic(egrid, ecfg)
    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(6, generator=gen),
              "b": torch.randn(6, generator=gen)}
    v = {k: torch.randn(6, generator=gen) for k in params}
    basis = torch.randn(6, *vp.shape, generator=gen)
    ebasis = torch.randn(6, *fields[0].shape, generator=gen)

    def run(device):
        p = {k: a.to(device) for k, a in params.items()}
        w = {k: a.to(device) for k, a in v.items()}
        b, eb = basis.to(device), ebasis.to(device)
        vp0 = torch.as_tensor(vp, device=device)
        wav = ricker(10.0, grid["nt"], grid["dt"], device=device)
        g = [torch.as_tensor(a, device=device) for a in geom]
        out = [composite_hvp(
            lambda q: vp0 + 20.0 * torch.tanh(torch.einsum("k,kij->ij",
                                                           q["a"], b)),
            lambda m: torch.mean(simulate_acoustic(m, wav, *g, acfg) ** 2),
            p, w)]
        f = [torch.as_tensor(a, device=device) for a in fields]
        ew = ricker(*ewargs, device=device)
        eg = [torch.as_tensor(a, device=device) for a in egeom]
        out.append(composite_hvp(
            lambda q: f[0] + 20.0 * torch.tanh(torch.einsum("k,kij->ij",
                                                            q["b"], eb)),
            lambda m: sum(torch.mean(t ** 2) for t in
                          ef.simulate_elastic_ring_plain(m, f[1], f[2], ew,
                                                         *eg, el)),
            p, w))
        return [{k: a.cpu() for k, a in h.items()} for h in out]

    got, ref = run(dev), run("cpu")
    for h, r in zip(got, ref):
        for k in h:
            assert rel_l2(h[k], r[k]) <= 1e-4, k
