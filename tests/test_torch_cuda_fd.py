"""The kernels' gradients against central differences on a CUDA card (the
counterpart of ``tpu_tests/test_pallas_tpu.py::test_scalar2_gradient_fd``).

The repository's correctness bar is a directional finite difference
against the adjoint: rel-err <= 1e-3.  ``tests/test_torch_cuda.py`` holds
each kernel to its plain version, which a sign or scale error shared by
the two would pass; here each differentiable propagator's gradient is
held to its own forward's central difference.  The case is the JAX
test's: 48 x 64 at dx 10 m, nt 480, PML 16, one shot at (24, 8), 30
receivers on row 4; the smooth l2 misfit ``mean((pred - obs)^2)`` against
the traces of a model with a +200 m/s block; a smoothed random
direction scaled to a largest entry of 1 (numpy seed 0); a central
difference at +-2 m/s.  The misfit of a difference is summed in float64
(the traces stay the kernels' float32), so that the sum's rounding does
not enter the quotient.

Each propagator runs on both of its routes (the resident plans hold
this grid), through its wrappers with ``route=``, as its
``autograd.Function`` composes them; the Function on its default route
gives the resident route's gradient to the bit.  The launch counters are
asserted, so each check is known to have gone through the kernel.
These need the card and ``nvcc`` and skip elsewhere; on a machine
without JAX run them with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu_torch.engine.config import get_workload
from physicsbasedfwi2_tpu_torch.geo import Grid2D, ricker
from physicsbasedfwi2_tpu_torch.ops import adjoint, kernels, scalar2, scalar2b
from physicsbasedfwi2_tpu_torch.ops import elastic_fused as ef
from physicsbasedfwi2_tpu_torch.ops.acoustic import AcousticConfig
from physicsbasedfwi2_tpu_torch.ops.elastic import ElasticConfig

pytestmark = pytest.mark.cuda

NZ, NX, NT = 48, 64, 480
STEP = 2.0  # m/s along the unit-max direction
TOL = 1e-3
ROUTES = ("resident", "per_step")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _grid():
    return Grid2D(nz=NZ, nx=NX, dx=10.0, nt=NT, dt=0.002, pml_width=16)


def _geom(dev):
    return (torch.tensor([24], dtype=torch.int32, device=dev),
            torch.tensor([8], dtype=torch.int32, device=dev),
            torch.full((1, 30), 4, dtype=torch.int32, device=dev),
            torch.arange(10, 40, dtype=torch.int32, device=dev)[None])


def _models(dev):
    vp = torch.full((NZ, NX), 1700.0, device=dev)
    vpt = vp.clone()
    vpt[20:30, 25:45] += 200.0
    return vp, vpt


def _direction(dev):
    d = np.random.default_rng(0).standard_normal((NZ, NX))
    for ax in (0, 1):
        d = 0.25 * (np.roll(d, 1, ax) + np.roll(d, -1, ax)) + 0.5 * d
    return torch.as_tensor(d / np.abs(d).max(), dtype=torch.float32,
                           device=dev)


def _counts(fns):
    return [(f.launches, f.resident_launches, f.per_step_launches)
            for f in fns]


def _check_launches(fns, before, calls, route):
    """Each wrapper in ``fns`` launched ``calls[i]`` times since
    ``before``, all on ``route``."""
    for f, b, a, n in zip(fns, before, _counts(fns), calls):
        on = a[1] - b[1] if route == "resident" else a[2] - b[2]
        assert (a[0] - b[0], on) == (n, n), (f.__name__, route, b, a)


def _fd_check(name, loss_of, vp, grad, d):
    fd = (loss_of(vp + STEP * d) - loss_of(vp - STEP * d)) / (2 * STEP)
    ad = float(torch.sum(grad.double() * d.double()))
    rel = abs(fd - ad) / max(abs(fd), 1e-30)
    print(f"{name}: directional FD {fd:.9e}, AD {ad:.9e}, rel-err "
          f"{rel:.3e} (tol {TOL:g})")
    assert np.isfinite(fd) and fd != 0.0, name
    assert rel < TOL, (name, fd, ad, rel)


def _acoustic_propagators(cfg, wav, geom):
    """name -> (forward(vp, route) -> traces, gradient(vp, ybar_of, route)
    -> dJ/dvp, the wrappers launched, their launches in one check), each
    as the propagator's ``autograd.Function`` composes its wrappers."""
    g = cfg.grid
    rcv_x = geom[3]

    def rows(ybar, kc):
        return scalar2.scatter_rows(ybar, rcv_x, nt=g.nt, nx=g.nx,
                                    pml_width=g.pml_width, KC=kc)

    def pallas2_grad(vp, ybar_of, route):
        recs, ckpt = scalar2.forward2_ckpt(vp, wav, *geom, cfg, route=route)
        return scalar2.backward2(vp, wav, *geom, cfg, rows(ybar_of(recs), 32),
                                 ckpt, route=route)

    def pallas_grad(vp, ybar_of, route):
        recs = kernels.acoustic_forward_pallas(vp, wav, *geom, cfg,
                                               route=route)
        return adjoint.acoustic_pallas_backward(
            vp, wav, *geom, cfg, rows(ybar_of(recs), adjoint.K_CKPT),
            route=route)

    def pallas2b_grad(vp, ybar_of, route):
        recs, ckpt = scalar2b.forward2b(vp, wav, *geom, cfg, route=route)
        return scalar2b.backward2b(vp, wav, *geom, cfg,
                                   rows(ybar_of(recs), scalar2b.KC), ckpt,
                                   route=route)

    return {
        # the primal without a vp gradient is B1, as the JAX custom VJP's
        "acoustic_pallas2": (
            lambda vp, route: scalar2.forward2(vp, wav, *geom, cfg,
                                               route=route),
            pallas2_grad, scalar2.acoustic_pallas2,
            (scalar2.forward2, scalar2.forward2_ckpt, scalar2.backward2),
            (2, 1, 1)),
        "acoustic_pallas": (
            lambda vp, route: kernels.acoustic_forward_pallas(
                vp, wav, *geom, cfg, route=route),
            pallas_grad, adjoint.acoustic_pallas,
            (kernels.acoustic_forward_pallas,
             adjoint.acoustic_pallas_backward), (3, 1)),
        "acoustic_pallas2b": (
            lambda vp, route: scalar2b.forward2b(vp, wav, *geom, cfg,
                                                 route=route)[0],
            pallas2b_grad, scalar2b.acoustic_pallas2b,
            (scalar2b.forward2b, scalar2b.backward2b), (3, 1)),
    }


@pytest.fixture(scope="module")
def acoustic(dev):
    grid = _grid()
    cfg = AcousticConfig(grid=grid, chunk=16, vmax_pml=2500.0)
    wav = ricker(10.0, grid.nt, grid.dt, device=dev)
    geom = _geom(dev)
    return cfg, wav, geom, _acoustic_propagators(cfg, wav, geom)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", ["acoustic_pallas2", "acoustic_pallas",
                                  "acoustic_pallas2b"])
def test_acoustic_gradient_matches_central_difference(dev, acoustic, name,
                                                      route):
    cfg, wav, geom, props = acoustic
    forward, gradient, function, fns, calls = props[name]
    g = cfg.grid
    nz8 = scalar2._round_up(g.nz + 2 * g.pml_width, 8)
    nx128 = scalar2._round_up(g.nx + 2 * g.pml_width, 128)
    plan = (kernels.acoustic_resident_plan if name == "acoustic_pallas"
            else scalar2.resident_plan)(nz8, nx128)
    assert plan is not None, "no resident plan holds the FD grid"
    vp, vpt = _models(dev)
    d = _direction(dev)
    with torch.no_grad():
        obs = forward(vpt, route)

    def loss(recs):
        return torch.mean((recs - obs) ** 2)

    def loss_of(v):
        with torch.no_grad():
            return float(torch.mean((forward(v, route).double()
                                     - obs.double()) ** 2))

    def ybar_of(recs):
        r = recs.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(loss(r), r)[0]

    torch.cuda.synchronize()
    before = _counts(fns)
    grad = gradient(vp, ybar_of, route)
    _fd_check(f"{name} ({route})", loss_of, vp, grad, d)
    torch.cuda.synchronize()
    _check_launches(fns, before, calls, route)
    if route == "resident":
        # the autograd.Function, on its default route, is this gradient
        v = vp.clone().requires_grad_(True)
        loss(function(v, wav, *geom, cfg)).backward()
        assert torch.equal(v.grad, grad), name


@pytest.mark.parametrize("route", ROUTES)
def test_b3_gradient_matches_central_difference(dev, route):
    grid = _grid()
    cfg = ElasticConfig(grid=grid, chunk=16, vmax_pml=2500.0)
    wav = ricker(10.0, grid.nt, grid.dt, device=dev)
    geom = _geom(dev)
    nz8, nx128 = ef._layout(cfg)[4:]
    assert ef.elastic_resident_plan(nz8, nx128) is not None
    vp, vpt = _models(dev)
    vs = torch.full_like(vp, 1000.0)
    rho = torch.full_like(vp, 2000.0)
    d = _direction(dev)
    ovx, ovz = ef.simulate_elastic_ring(vpt, vs, rho, wav, *geom, cfg)
    orx, orz = (ef.scatter_rows_el(o, geom[3], cfg, KC=8)
                for o in (ovx, ovz))
    damp = ef.prep_damp(cfg, dev)
    fn = ef.fused_elastic_loss_grad_meds

    def loss_grad(v, want_grad):
        v = v.detach().requires_grad_(want_grad)
        with torch.enable_grad():
            meds = ef.prep_medium(v, vs, rho, cfg)
        loss, gmeds = fn(meds, damp, wav, *geom, cfg, orx, orz, KC=8,
                         misfit="l2", route=route)
        if not want_grad:
            return float(loss), None
        # the pullback through prep_medium (muxz has no vp in it)
        outs, cots = zip(*[(m, gm) for m, gm in zip(meds, gmeds)
                           if m.requires_grad])
        return float(loss), torch.autograd.grad(outs, v, cots)[0]

    torch.cuda.synchronize()
    before = _counts([fn])
    _, grad = loss_grad(vp, True)
    _fd_check(f"B3 l2 ({route})", lambda v: loss_grad(v, False)[0], vp,
              grad, d)
    torch.cuda.synchronize()
    _check_launches([fn], before, (3,), route)


# seam_elastic's and real_data's grids (144 x 384 in kernel layout with a
# free surface, 192 x 384 with an absorbing top), whose B3 plans cut them
# into 16 bands of 9 and of 12 rows (layout 1); nt cut to TALL_NT
TALL = {"seam_elastic": ((144, 384), 9), "real_data": ((192, 384), 12)}
TALL_NT = 400


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("workload", sorted(TALL))
def test_b3_tall_grid_gradient_matches_central_difference(dev, workload,
                                                          route):
    """B3 at the workload's grid, dx, dt, wavelet and acquisition rows
    (2 shots, 30 receivers), nt cut to 400, on both routes: the same
    directional check as above, on a model of 2500 m/s with a +200 m/s
    block 4-16 rows below the receivers (its reflection reaches them
    within the cut record); then both routes' loss and gradient to the
    bit."""
    c = get_workload(workload)
    grid = Grid2D(nz=c.nz, nx=c.nx, dx=c.dx, nt=TALL_NT, dt=c.dt,
                  pml_width=c.pml_width, free_surface=c.free_surface)
    cfg = ElasticConfig(grid=grid, chunk=c.chunk, vmax_pml=5000.0)
    shape, rows = TALL[workload]
    plan = ef.elastic_resident_plan(*ef._layout(cfg)[4:])
    assert ef._layout(cfg)[4:] == shape
    assert (plan.cluster, plan.band_rows, plan.layout) == (16, rows, 1)
    wav = ricker(c.freq, TALL_NT, c.dt, device=dev)
    nz, nx, rcv_row = c.nz, c.nx, c.extras["rcv_depth_row"]
    geom = (torch.full((2,), c.extras["src_depth_row"], dtype=torch.int32,
                       device=dev),
            torch.tensor([nx // 3, 2 * nx // 3], dtype=torch.int32,
                         device=dev),
            torch.full((2, 30), rcv_row, dtype=torch.int32, device=dev),
            torch.arange(5, nx - 5, (nx - 10) // 30, dtype=torch.int32,
                         device=dev)[None, :30].expand(2, 30).contiguous())
    vp = torch.full((nz, nx), 2500.0, device=dev)
    vpt = vp.clone()
    vpt[rcv_row + 4:rcv_row + 16, nx // 3:2 * nx // 3] += 200.0
    vs = torch.full_like(vp, 1200.0)
    rho = torch.full_like(vp, 2000.0)
    d = np.random.default_rng(0).standard_normal((nz, nx))
    for ax in (0, 1):
        d = 0.25 * (np.roll(d, 1, ax) + np.roll(d, -1, ax)) + 0.5 * d
    d = torch.as_tensor(d / np.abs(d).max(), dtype=torch.float32,
                        device=dev)
    ovx, ovz = ef.simulate_elastic_ring(vpt, vs, rho, wav, *geom, cfg)
    orx, orz = (ef.scatter_rows_el(o, geom[3], cfg, KC=8)
                for o in (ovx, ovz))
    damp = ef.prep_damp(cfg, dev)
    fn = ef.fused_elastic_loss_grad_meds

    def loss_grad(v, want_grad, route=route):
        v = v.detach().requires_grad_(want_grad)
        with torch.enable_grad():
            meds = ef.prep_medium(v, vs, rho, cfg)
        loss, gmeds = fn(meds, damp, wav, *geom, cfg, orx, orz, KC=8,
                         misfit="l2", route=route)
        if not want_grad:
            return loss, gmeds
        outs, cots = zip(*[(m, gm) for m, gm in zip(meds, gmeds)
                           if m.requires_grad])
        return float(loss), torch.autograd.grad(outs, v, cots)[0]

    torch.cuda.synchronize()
    before = _counts([fn])
    _, grad = loss_grad(vp, True)
    _fd_check(f"B3 l2 at {workload}'s grid ({route})",
              lambda v: float(loss_grad(v, False)[0]), vp, grad, d)
    torch.cuda.synchronize()
    _check_launches([fn], before, (3,), route)
    other = "per_step" if route == "resident" else "resident"
    la, ga = loss_grad(vp, False)
    lb, gb = loss_grad(vp, False, other)
    assert torch.equal(la, lb) and float(la) > 0
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
