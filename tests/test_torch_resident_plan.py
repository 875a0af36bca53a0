"""The launch planner of the resident route of kernels B1, B2, B4a and
B4b (``ops/scalar2.py::resident_plan``): what it maps each grid to, and
that CPU tensors never reach either CUDA route."""

import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu_torch.ops import scalar2
from physicsbasedfwi2_tpu_torch.ops.fwi_fused import fwi_l1_loss_grad
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    SMEM_LIMIT, ResidentPlan, pick_route, resident_plan,
)

from torch_parity import acoustic_case, t, torch_acoustic

torch.set_num_threads(1)

# (nz8, nx128) grids: the flagship, the CUDA tests' cases, odd band
# counts, wide and tall grids
GRIDS = [(192, 256), (64, 128), (88, 256), (40, 128), (56, 384),
         (200, 256), (96, 512), (248, 128)]


def test_flagship_plan_fits_shared_memory():
    plan = resident_plan(192, 256)
    assert plan == ResidentPlan(cluster=5, band_rows=40, threads=512,
                                smem_bytes=215_808)
    assert plan.args() == (5, 40, 5, 512, 215_808)
    assert plan.smem_bytes <= SMEM_LIMIT == 232_448
    assert plan.bands(192) == [(0, 40), (40, 80), (80, 120), (120, 160),
                               (160, 192)]
    # 4 CTAs do not fit: 48-row bands need 10 x 64 = 640 threads


@pytest.mark.parametrize("nz8,nx128", GRIDS)
def test_bands_cover_every_row_once(nz8, nx128):
    plan = resident_plan(nz8, nx128)
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
    assert plan.threads // per_row * scalar2.ROWS_PER_THREAD >= plan.band_rows
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("nz8,nx128,bands", [
    (192, 256, [40] * 4 + [32]), (64, 128, [64]), (40, 128, [40]),
    (88, 128, [48, 40]), (88, 256, [32, 32, 24]), (56, 384, [24, 24, 8]),
    (248, 128, [64] * 3 + [56])])
def test_default_plan_cluster_size(nz8, nx128, bands):
    # the smallest cluster that fits, whatever the shot count
    plan = resident_plan(nz8, nx128)
    assert [b - a for a, b in plan.bands(nz8)] == bands


@pytest.mark.parametrize("nz8,nx128", [(72, 1024), (64, 2048), (4096, 256)])
def test_grids_beyond_the_plan_take_the_per_step_route(nz8, nx128):
    assert resident_plan(nz8, nx128) is None
    assert pick_route("forward2", nz8, nx128) == ("per_step", None)
    with pytest.raises(ValueError, match="no resident plan"):
        pick_route("forward2", nz8, nx128, "resident")


def test_pick_route_takes_a_route_name():
    plan = resident_plan(64, 128)
    assert pick_route("forward2", 64, 128) == ("resident", plan)
    assert pick_route("forward2", 64, 128, "resident") == ("resident", plan)
    assert pick_route("forward2", 64, 128, "per_step")[0] == "per_step"
    for bad in ("cuda", plan):
        with pytest.raises(ValueError, match="route must be"):
            pick_route("forward2", 64, 128, bad)


@pytest.mark.parametrize("route", [None, "resident", "per_step"])
def test_cpu_tensors_reach_no_route(route):
    grid, cfg, wargs, vp, geom = acoustic_case()
    grid = dict(grid, nt=40)
    cfg = torch_acoustic(grid, cfg)
    from physicsbasedfwi2_tpu_torch.geo import ricker
    wav = ricker(wargs[0], 40, wargs[2])
    vp, geom = t(vp), tuple(map(t, geom))
    fns = (scalar2.forward2, scalar2.forward2_ckpt, scalar2.backward2,
           fwi_l1_loss_grad)
    saved = [(f.launches, f.resident_launches, f.per_step_launches)
             for f in fns]
    scalar2.reset_launches(*fns)
    try:
        scalar2.forward2(vp, wav, *geom, cfg, route=route)
        recs, ckpt = scalar2.forward2_ckpt(vp, wav, *geom, cfg, KC=8,
                                           route=route)
        rows = scalar2.scatter_rows(recs, geom[3], nt=40, nx=44,
                                    pml_width=12, KC=8)
        scalar2.backward2(vp, wav, *geom, cfg, rows, ckpt, route=route)
        obs = torch.zeros((2, 64, 128))
        fwi_l1_loss_grad(vp, wav, *geom, cfg, obs, obs, route=route)
        assert [(f.launches, f.resident_launches, f.per_step_launches)
                for f in fns] == [(0, 0, 0)] * 4
    finally:
        for f, (a, b, c) in zip(fns, saved):
            f.launches, f.resident_launches, f.per_step_launches = a, b, c
