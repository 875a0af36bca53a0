"""The launch planners of kernel B3's resident route
(``ops/elastic_fused.py::elastic_resident_plan``) and of the forward
sweep alone, the ring forward's and B8's
(``elastic_forward_plan``): what they map each grid to, in which
shared-memory layout, which workloads' grids they hold, and that CPU
tensors never reach a CUDA route."""

import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu_torch.engine.config import get_workload
from physicsbasedfwi2_tpu_torch.geo import Grid2D, ricker
from physicsbasedfwi2_tpu_torch.ops import elastic_fused as ef
from physicsbasedfwi2_tpu_torch.ops import elastic_fwd
from physicsbasedfwi2_tpu_torch.ops.elastic import ElasticConfig
from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
    EL_B3_BANDS, EL_FWD_BANDS, EL_MAX_CLUSTER, EL_MAX_COLS, EL_ROWS, el_smem,
    elastic_forward_plan, elastic_resident_plan,
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
    (208, 384),    # 26 bands of 8, no whole number of 9 or 12
    (160, 384),    # 20 bands of 8; no instance has bands of 10
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
    ("seam_elastic", True), ("seam_elastic_robust", True),
    ("real_data", True)])
def test_workload_grids(name, held):
    # the marmousi_elastic family trains on 128 x 384 in kernel layout,
    # SEAM on 144 x 384, real_data on 192 x 384
    c = get_workload(name)
    cfg = ElasticConfig(grid=Grid2D(nz=c.nz, nx=c.nx, dx=c.dx, nt=c.nt,
                                    dt=c.dt, pml_width=c.pml_width,
                                    free_surface=c.free_surface),
                        chunk=c.chunk)
    nz8, nx128 = ef._layout(cfg)[4:]
    assert (elastic_resident_plan(nz8, nx128) is not None) == held
    want = {"seam": (144, 384), "real": (192, 384)}.get(name[:4],
                                                         (128, 384))
    assert (nz8, nx128) == want
    assert _planned(nz8, nx128)[0] == "resident"


@pytest.mark.parametrize("nz8,nx128,rows,smem", [
    (144, 384, 9, 171_040),    # seam_elastic
    (192, 384, 12, 217_600),   # real_data
    (144, 128, 9, 58_400),     # the CUDA tests' cases
    (192, 128, 12, 74_240),
])
def test_tall_plans_fit_shared_memory(nz8, nx128, rows, smem):
    plan = elastic_resident_plan(nz8, nx128)
    assert plan == ResidentPlan(cluster=16, band_rows=rows, threads=nx128,
                                smem_bytes=smem, rows_per_thread=rows,
                                layout=1)
    assert plan.args() == (16, rows, rows, nx128, smem)
    # 5 field buffers with 2 halo rows and 4 zero columns each side, and
    # the 5 gradient accumulators of the band's cells; the media are read
    # through L1
    assert smem == 4 * (5 * (rows + 4) * (nx128 + 8) + 5 * rows * nx128)
    assert smem == el_smem(rows, nx128, 1, reverse=True) <= SMEM_LIMIT
    # the forward sweep of the same plan takes the field buffers alone
    assert el_smem(rows, nx128, 1, reverse=False) == 4 * 5 * (rows + 4) * (
        nx128 + 8)
    bands = plan.bands(nz8)
    assert bands == [(rows * r, rows * r + rows) for r in range(16)]
    assert _planned(nz8, nx128) == ("resident", plan)


def test_layout_0_cannot_hold_the_tall_bands():
    # with the band's 6 media in shared memory the reverse sweep of 12
    # rows would not fit, nor would layout 1's gradients beside them
    assert el_smem(12, 384, 0, reverse=True) == 236_032 > SMEM_LIMIT
    assert (el_smem(9, 384, 1, reverse=True) + 4 * 6 * 9 * 384
            > SMEM_LIMIT)
    assert EL_B3_BANDS == ((EL_ROWS, 0), (9, 1), (12, 1))


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


# ---------------------------------------------------------------------------
# the forward sweep alone: the ring forward and B8 (bands of 8 or 9 rows)
# ---------------------------------------------------------------------------

def _fwd_planned(nz8, nx128, what="simulate_elastic_ring"):
    return pick_route(what, nz8, nx128, plan_fn=elastic_forward_plan)


@pytest.mark.parametrize("nz8,nx128,rows,smem", [
    (128, 384, 8, 167_808),   # marmousi_elastic's ring forward: B3's plan
    (144, 384, 9, 184_864),   # B8 at marmousi_elastic's shape, seam_elastic
    (192, 384, 12, 125_440),  # real_data (layout 1)
])
def test_forward_plan_fits_shared_memory(nz8, nx128, rows, smem):
    plan = elastic_forward_plan(nz8, nx128)
    layout = 1 if rows == 12 else 0
    assert plan == ResidentPlan(cluster=16, band_rows=rows, threads=384,
                                smem_bytes=smem, rows_per_thread=rows,
                                layout=layout)
    assert plan.args() == (16, rows, rows, 384, smem)
    # 5 field buffers with 2 halo rows and 4 zero columns each side, and
    # in layout 0 the band's 6 media
    media = 6 * rows * 384 if layout == 0 else 0
    assert smem == 4 * (5 * (rows + 4) * 392 + media) <= SMEM_LIMIT
    assert smem == el_smem(rows, 384, layout, reverse=False)
    assert _fwd_planned(nz8, nx128) == ("resident", plan)


def test_forward_plan_takes_b3s_plan_where_it_holds():
    assert EL_FWD_BANDS == ((EL_ROWS, 0), (9, 0), (12, 1))
    for nz8, nx128 in GRIDS:
        assert elastic_forward_plan(nz8, nx128) == elastic_resident_plan(
            nz8, nx128)
    # where 9-row bands hold the grid, the forward sweep alone keeps its
    # layout-0 instance and B3 takes layout 1
    assert elastic_resident_plan(144, 384).layout == 1
    assert elastic_forward_plan(144, 384).band_rows == 9
    assert elastic_forward_plan(144, 384).layout == 0


@pytest.mark.parametrize("nz8,nx128", GRIDS + [(144, 384), (144, 128),
                                               (72, 256), (192, 384)])
def test_forward_bands_cover_every_row_once(nz8, nx128):
    plan = elastic_forward_plan(nz8, nx128)
    bands = plan.bands(nz8)
    rows = np.concatenate([np.arange(a, b) for a, b in bands])
    np.testing.assert_array_equal(rows, np.arange(nz8))
    assert len(bands) == plan.cluster <= EL_MAX_CLUSTER
    assert all(b - a == plan.band_rows for a, b in bands)
    # the smallest height that holds the grid, one thread a column
    assert (plan.band_rows, plan.layout) == min(
        (R, layout) for R, layout in EL_FWD_BANDS
        if nz8 % R == 0 and nz8 // R <= EL_MAX_CLUSTER)
    assert plan.threads == nx128 <= EL_MAX_COLS
    assert plan.rows_per_thread == plan.band_rows
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("nz8,nx128", [
    (208, 384),    # 26 bands of 8, no whole number of 9 or 12
    (136, 128),    # 17 bands of 8
    (64, 512),     # wider than 384 threads
    (44, 128),     # neither 8- nor 9-row bands
])
def test_forward_grids_beyond_the_plan_take_the_other_routes(nz8, nx128):
    assert elastic_forward_plan(nz8, nx128) is None
    assert _fwd_planned(nz8, nx128) == ("per_step", None)
    assert _fwd_planned(nz8, nx128, "elastic_forward_pallas") == (
        "per_step", None)
    with pytest.raises(ValueError, match="no resident plan"):
        pick_route("elastic_forward_pallas", nz8, nx128, "resident",
                   elastic_forward_plan)


@pytest.mark.parametrize("name,free_surface,shape", [
    ("marmousi_elastic", None, (128, 384)),   # the engine's ring forward
    ("marmousi_elastic", False, (144, 384)),  # B8's case at that shape
    ("seam_elastic", None, (144, 384)),
    ("real_data", None, (192, 384)),          # its ring forward (prep)
])
def test_forward_plan_holds_the_workload_grids(name, free_surface, shape):
    c = get_workload(name)
    fs = c.free_surface if free_surface is None else free_surface
    cfg = ElasticConfig(grid=Grid2D(nz=c.nz, nx=c.nx, dx=c.dx, nt=c.nt,
                                    dt=c.dt, pml_width=c.pml_width,
                                    free_surface=fs), chunk=c.chunk)
    assert ef._layout(cfg)[4:] == shape
    assert elastic_forward_plan(*shape) is not None
    if not fs:
        # B8 pads to the same grid as the ring forward
        _, _, b8_shape = elastic_fwd._prepare_el(
            *(torch.full((c.nz, c.nx), v) for v in (2000.0, 1000.0, 2000.0)),
            cfg)
        assert b8_shape == shape


def test_b8_route_names():
    # B8 runs the ring forward's kernels, so it has the ring forward's
    # two routes and no other
    assert _fwd_planned(144, 384, "elastic_forward_pallas")[0] == "resident"
    assert pick_route("elastic_forward_pallas", 144, 384, "per_step",
                      elastic_forward_plan)[0] == "per_step"
    for bad in ("cooperative", "cuda"):
        with pytest.raises(ValueError, match="route must be"):
            pick_route("elastic_forward_pallas", 144, 384, bad,
                       elastic_forward_plan)


def _fwd_cpu_case(free_surface):
    grid, cfg, wargs, med, geom = elastic_case(free_surface=free_surface)
    grid = dict(grid, nt=24)
    return (torch_elastic(grid, cfg), ricker(wargs[0], 24, wargs[2]),
            tuple(torch.as_tensor(a) for a in med),
            tuple(torch.as_tensor(a) for a in geom))


@pytest.mark.parametrize("route", [None, "resident", "per_step"])
def test_cpu_tensors_reach_no_ring_forward_route(route):
    cfg, wav, med, geom = _fwd_cpu_case(True)
    fn = ef.simulate_elastic_ring
    saved = (fn.launches, fn.resident_launches, fn.per_step_launches)
    reset_launches(fn)
    try:
        got = fn(*med, wav, *geom, cfg, route=route)
        assert (fn.launches, fn.resident_launches,
                fn.per_step_launches) == (0, 0, 0)
    finally:
        fn.launches, fn.resident_launches, fn.per_step_launches = saved
    ref = ef.simulate_elastic_ring_plain(*med, wav, *geom, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert float(got[0].abs().max()) > 0


@pytest.mark.parametrize("route", [None, "resident", "per_step"])
def test_cpu_tensors_reach_no_b8_route(route):
    cfg, wav, med, geom = _fwd_cpu_case(False)
    fn = elastic_fwd.elastic_forward_pallas
    saved = (fn.launches, fn.resident_launches, fn.per_step_launches)
    reset_launches(fn)
    try:
        got = fn(*med, wav, *geom, cfg, route=route)
        assert (fn.launches, fn.resident_launches,
                fn.per_step_launches) == (0, 0, 0)
    finally:
        fn.launches, fn.resident_launches, fn.per_step_launches = saved
    ref = elastic_fwd.elastic_forward_pallas_plain(*med, wav, *geom, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert float(got[0].abs().max()) > 0
