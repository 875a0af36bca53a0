"""The launch planner of the resident route of kernels B5 and B6
(``ops/kernels.py::acoustic_resident_plan``): what it maps each grid
to, that the decay-factor profiles the resident kernels read rebuild
the factors exactly, and that CPU tensors never reach either CUDA
route."""

import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu_torch.geo import ricker
from physicsbasedfwi2_tpu_torch.ops import adjoint, kernels, scalar2
from physicsbasedfwi2_tpu_torch.ops.kernels import (
    acoustic_resident_plan, damp_profiles,
)
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    SMEM_LIMIT, ResidentPlan, pick_route,
)

from torch_parity import acoustic_case, t, torch_acoustic

torch.set_num_threads(1)

# (nz8, nx128) grids: the flagship, the CUDA tests' cases, odd band
# counts, wide and tall grids
GRIDS = [(192, 256), (64, 128), (88, 256), (40, 128), (56, 384),
         (200, 256), (128, 384), (248, 128)]


def test_flagship_plan_fits_shared_memory():
    plan = acoustic_resident_plan(192, 256)
    # 4 planes of 44 x 264, kap 40 x 256, row profiles 2 x 40
    assert plan == ResidentPlan(cluster=5, band_rows=40, threads=512,
                                smem_bytes=227_136)
    assert plan.smem_bytes == 4 * (4 * 44 * 264 + 40 * 256 + 80)
    assert plan.args() == (5, 40, 5, 512, 227_136)
    assert plan.smem_bytes <= SMEM_LIMIT == 232_448
    assert plan.bands(192) == [(0, 40), (40, 80), (80, 120), (120, 160),
                               (160, 192)]
    # 4 CTAs do not fit: 48-row bands need 10 x 64 = 640 threads


@pytest.mark.parametrize("nz8,nx128", GRIDS)
def test_bands_cover_every_row_once(nz8, nx128):
    plan = acoustic_resident_plan(nz8, nx128)
    bands = plan.bands(nz8)
    rows = np.concatenate([np.arange(a, b) for a, b in bands])
    np.testing.assert_array_equal(rows, np.arange(nz8))
    assert len(bands) == plan.cluster <= scalar2.MAX_CLUSTER
    assert plan.band_rows % 8 == 0
    assert all(b - a >= 2 for a, b in bands)
    # every thread a block of rows of 4 columns; they cover the band
    per_row = nx128 // scalar2.COLS_PER_THREAD
    assert plan.threads % per_row == 0
    assert plan.threads <= scalar2.RES_THREADS
    H = plan.threads // per_row * scalar2.ROWS_PER_THREAD
    assert H >= plan.band_rows
    assert plan.smem_bytes == 4 * (kernels.AC_PLANES * (H + 4) * (nx128 + 8)
                                   + plan.band_rows * nx128
                                   + 2 * plan.band_rows)
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("nz8,nx128,bands", [
    (192, 256, [40] * 4 + [32]), (64, 128, [64]), (40, 128, [40]),
    (88, 256, [32, 32, 24]), (128, 384, [24] * 5 + [8]),
    (248, 128, [64] * 3 + [56])])
def test_default_plan_cluster_size(nz8, nx128, bands):
    # the smallest cluster that fits, whatever the shot count
    plan = acoustic_resident_plan(nz8, nx128)
    assert [b - a for a, b in plan.bands(nz8)] == bands


@pytest.mark.parametrize("nz8,nx128", [(72, 1024), (64, 2048), (4096, 256)])
def test_grids_beyond_the_plan_take_the_per_step_route(nz8, nx128):
    assert acoustic_resident_plan(nz8, nx128) is None
    assert pick_route("acoustic_forward_pallas", nz8, nx128,
                      plan_fn=acoustic_resident_plan) == ("per_step", None)
    with pytest.raises(ValueError, match="no resident plan"):
        pick_route("acoustic_pallas_backward", nz8, nx128, "resident",
                   acoustic_resident_plan)


def test_pick_route_takes_a_route_name():
    plan = acoustic_resident_plan(64, 128)
    pick = lambda r=None: pick_route("acoustic_forward_pallas", 64, 128, r,
                                     acoustic_resident_plan)
    assert pick() == ("resident", plan)
    assert pick("resident") == ("resident", plan)
    assert pick("per_step")[0] == "per_step"
    for bad in ("cuda", plan):
        with pytest.raises(ValueError, match="route must be"):
            pick(bad)


def _case(free_surface=False):
    grid, cfg, wargs, vp, geom = acoustic_case()
    grid = dict(grid, nt=40, free_surface=free_surface)
    return (torch_acoustic(grid, cfg), ricker(wargs[0], 40, wargs[2]),
            t(vp), tuple(map(t, geom)))


@pytest.mark.parametrize("free_surface", [False, True])
def test_damp_profiles_rebuild_the_factors_exactly(free_surface):
    cfg, wav, vp, geom = _case(free_surface)
    _, damp, *_ = kernels.operands(vp, wav, *geom[:3], cfg, nt_pad=48,
                                   gain="b6")
    xpr, zpr = damp_profiles(damp)
    nz8, nx128 = damp[0].shape
    assert xpr.shape == (2, nx128) and zpr.shape == (2, nz8)
    # what xfac and zfac in csrc/acoustic.cu compute: the column profile
    # on rows where az_v's profile is nonzero, the row profile on columns
    # where ax_v's profile is nonzero
    ring_row = (zpr[0] != 0)[:, None]
    ring_col = (xpr[0] != 0)[None, :]
    zero = torch.zeros(())
    rebuilt = (torch.where(ring_row, xpr[0][None, :], zero),
               torch.where(ring_col, zpr[0][:, None], zero),
               torch.where(ring_row, xpr[1][None, :], zero),
               torch.where(ring_col, zpr[1][:, None], zero))
    for got, ref in zip(rebuilt, damp):
        assert torch.equal(got, ref)
    # the ring: 2 zero cells at the padded domain's edge, the alignment
    # pad zero too
    nzp = cfg.grid.padded_shape[0]
    assert ring_row[:, 0].tolist() == [2 <= i < nzp - 2 for i in range(nz8)]


@pytest.mark.parametrize("route", [None, "resident", "per_step"])
def test_cpu_tensors_reach_no_route(route):
    cfg, wav, vp, geom = _case()
    fns = (kernels.acoustic_forward_pallas,
           adjoint.acoustic_pallas_backward)
    saved = [(f.launches, f.resident_launches, f.per_step_launches)
             for f in fns]
    scalar2.reset_launches(*fns)
    try:
        recs = kernels.acoustic_forward_pallas(vp, wav, *geom, cfg,
                                               route=route)
        assert torch.equal(recs, kernels.acoustic_forward_pallas_plain(
            vp, wav, *geom, cfg))
        rows = scalar2.scatter_rows(recs, geom[3], nt=40, nx=44,
                                    pml_width=12, KC=adjoint.K_CKPT)
        gk = adjoint.acoustic_pallas_backward(vp, wav, *geom, cfg, rows,
                                              route=route)
        assert torch.equal(gk, adjoint.acoustic_pallas_backward_plain(
            vp, wav, *geom, cfg, rows))
        v = vp.clone().requires_grad_(True)
        adjoint.acoustic_pallas(v, wav, *geom, cfg).square().sum().backward()
        assert bool(torch.isfinite(v.grad).all())
        assert [(f.launches, f.resident_launches, f.per_step_launches)
                for f in fns] == [(0, 0, 0)] * 2
    finally:
        for f, (a, b, c) in zip(fns, saved):
            f.launches, f.resident_launches, f.per_step_launches = a, b, c
