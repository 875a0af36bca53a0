"""The launch planner of kernel B3's resident route
(``ops/elastic_fused.py::elastic_resident_plan``): what it maps each
grid to, which workloads' grids it holds, and that CPU tensors never
reach either CUDA route."""

import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu_torch.engine.config import get_workload
from physicsbasedfwi2_tpu_torch.geo import Grid2D, ricker
from physicsbasedfwi2_tpu_torch.ops import elastic_fused as ef
from physicsbasedfwi2_tpu_torch.ops.elastic import ElasticConfig
from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
    EL_MAX_CLUSTER, EL_MAX_COLS, EL_ROWS, elastic_resident_plan,
)
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    SMEM_LIMIT, ResidentPlan, pick_route, reset_launches,
)

from torch_parity import elastic_case, torch_elastic

torch.set_num_threads(1)

# (nz8, nx128) grids the plan holds: the marmousi_elastic family, the
# CUDA tests' cases (free surface and absorbing top), one band, narrow
# and middle widths
GRIDS = [(128, 384), (48, 128), (56, 128), (8, 128), (128, 128),
         (88, 256), (40, 384)]


def _planned(nz8, nx128):
    return pick_route("fused_elastic_loss_grad_meds", nz8, nx128,
                      plan_fn=elastic_resident_plan)


def test_marmousi_elastic_plan_fits_shared_memory():
    plan = elastic_resident_plan(128, 384)
    assert plan == ResidentPlan(cluster=16, band_rows=8, threads=384,
                                smem_bytes=167_808, rows_per_thread=8)
    assert plan.args() == (16, 8, 8, 384, 167_808)
    assert plan.smem_bytes <= SMEM_LIMIT == 232_448
    assert plan.bands(128) == [(8 * r, 8 * r + 8) for r in range(16)]
    # 5 field buffers with 2 halo rows and 4 zero columns each side,
    # and the band's 6 media
    assert plan.smem_bytes == 4 * (5 * 12 * 392 + 6 * 8 * 384)


@pytest.mark.parametrize("nz8,nx128", GRIDS)
def test_bands_cover_every_row_once(nz8, nx128):
    plan = elastic_resident_plan(nz8, nx128)
    bands = plan.bands(nz8)
    rows = np.concatenate([np.arange(a, b) for a, b in bands])
    np.testing.assert_array_equal(rows, np.arange(nz8))
    assert len(bands) == plan.cluster <= EL_MAX_CLUSTER
    assert all(b - a == EL_ROWS for a, b in bands)
    # one thread a column, each owning the band's rows
    assert plan.threads == nx128 <= EL_MAX_COLS
    assert plan.rows_per_thread == plan.band_rows == EL_ROWS
    assert plan.smem_bytes <= SMEM_LIMIT
    assert _planned(nz8, nx128) == ("resident", plan)


@pytest.mark.parametrize("nz8,nx128", [
    (144, 384),    # seam_elastic: 18 CTAs, more than a cluster can have
    (192, 384),    # real_data
    (136, 128),    # 17 CTAs
    (64, 512),     # wider than 384 threads
    (64, 2048),
    (44, 128),     # not a whole number of 8-row bands
])
def test_grids_beyond_the_plan_take_the_per_step_route(nz8, nx128):
    assert elastic_resident_plan(nz8, nx128) is None
    assert _planned(nz8, nx128) == ("per_step", None)
    with pytest.raises(ValueError, match="no resident plan"):
        pick_route("fused_elastic_loss_grad_meds", nz8, nx128, "resident",
                   elastic_resident_plan)


@pytest.mark.parametrize("name,held", [
    ("marmousi_elastic", True), ("marmousi_elastic_real", True),
    ("marmousi_elastic_parity", True), ("marmousi_elastic_rho", True),
    ("seam_elastic", False), ("real_data", False)])
def test_workload_grids(name, held):
    # the marmousi_elastic family trains on 128 x 384 in kernel layout
    c = get_workload(name)
    cfg = ElasticConfig(grid=Grid2D(nz=c.nz, nx=c.nx, dx=c.dx, nt=c.nt,
                                    dt=c.dt, pml_width=c.pml_width,
                                    free_surface=c.free_surface),
                        chunk=c.chunk)
    nz8, nx128 = ef._layout(cfg)[4:]
    assert (elastic_resident_plan(nz8, nx128) is not None) == held
    if name.startswith("marmousi"):
        assert (nz8, nx128) == (128, 384)


def test_pick_route_checks_the_route_name():
    plan = elastic_resident_plan(48, 128)
    assert _planned(48, 128) == ("resident", plan)
    assert pick_route("b3", 48, 128, "per_step",
                      elastic_resident_plan)[0] == "per_step"
    for bad in ("cuda", "Resident", plan):
        with pytest.raises(ValueError, match="route must be"):
            pick_route("b3", 48, 128, bad, elastic_resident_plan)


@pytest.mark.parametrize("route", [None, "resident", "per_step"])
def test_cpu_tensors_reach_no_route(route):
    grid, cfg, wargs, med, geom = elastic_case()
    grid = dict(grid, nt=24)
    cfg = torch_elastic(grid, cfg)
    wav = ricker(wargs[0], 24, wargs[2])
    med = tuple(torch.as_tensor(a) for a in med)
    geom = tuple(torch.as_tensor(a) for a in geom)
    rows = [ef.scatter_rows_el(o, geom[3], cfg, KC=8)
            for o in ef.simulate_elastic_ring_plain(*med, wav, *geom, cfg)]
    meds = ef.prep_medium(med[0] * 0.95, med[1], med[2], cfg)
    damp = ef.prep_damp(cfg)
    args = (meds, damp, wav, *geom, cfg, *rows)
    fn = ef.fused_elastic_loss_grad_meds
    saved = (fn.launches, fn.resident_launches, fn.per_step_launches)
    reset_launches(fn)
    try:
        lk, gk = fn(*args, KC=8, route=route)
        assert (fn.launches, fn.resident_launches,
                fn.per_step_launches) == (0, 0, 0)
    finally:
        fn.launches, fn.resident_launches, fn.per_step_launches = saved
    lp, gp = ef.fused_elastic_loss_grad_meds_plain(*args, KC=8)
    assert torch.equal(lk, lp)
    assert all(torch.equal(a, b) for a, b in zip(gk, gp))
    assert float(lk) > 0
