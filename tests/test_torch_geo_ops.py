"""PyTorch port vs the JAX package: grids, wavelets, geometry, PML,
the second-order coefficients, misfit/gradient helpers, the
first-order propagator and the synthetic workload."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.geo import (
    Grid2D as JGrid2D, cfl_dt as j_cfl_dt, check_cfl as j_check_cfl,
    ricker as j_ricker, surface_line as j_surface_line,
)
from physicsbasedfwi2_tpu.ops import (
    simulate_acoustic as j_simulate, trace_normalize as j_trace_normalize,
)
from physicsbasedfwi2_tpu.ops import gradproc as j_gradproc
from physicsbasedfwi2_tpu.ops import pml as j_pml
from physicsbasedfwi2_tpu.ops.misfit import l1_misfit as j_l1
from physicsbasedfwi2_tpu.ops.pallas_scalar2 import _prepare2 as j_prepare2
from physicsbasedfwi2_tpu_torch.geo import (
    Grid2D, cfl_dt, check_cfl, ricker, surface_line,
)
from physicsbasedfwi2_tpu_torch.ops import (
    simulate_acoustic, trace_normalize,
)
from physicsbasedfwi2_tpu_torch.ops import gradproc, pml
from physicsbasedfwi2_tpu_torch.ops.misfit import l1_misfit
from physicsbasedfwi2_tpu_torch.ops.scalar2 import _prepare2

from torch_parity import (
    acoustic_case, golden, jax_acoustic, n, port_workload, rel_max, t,
    torch_acoustic,
)

torch.set_num_threads(1)


def test_grid_and_cfl_match():
    kw = dict(nz=30, nx=41, dx=12.5, nt=100, dt=0.002, pml_width=9)
    for fs in (False, True):
        a, b = JGrid2D(**kw, free_surface=fs), Grid2D(**kw, free_surface=fs)
        assert (a.padded_shape, a.top_pad, a.duration) == (
            b.padded_shape, b.top_pad, b.duration)
    for order in (2, 4, 8):
        assert j_cfl_dt(4700.0, 10.0, order) == cfl_dt(4700.0, 10.0, order)
    bad = Grid2D(nz=10, nx=10, dx=10.0, nt=10, dt=0.01)
    with pytest.raises(ValueError):
        check_cfl(4700.0, bad)
    with pytest.raises(ValueError):
        j_check_cfl(4700.0, JGrid2D(nz=10, nx=10, dx=10.0, nt=10, dt=0.01))
    check_cfl(4700.0, Grid2D(nz=10, nx=10, dx=10.0, nt=10, dt=0.001))


@pytest.mark.parametrize("freq,nt,dt", [(8.0, 4001, 0.001),
                                        (10.0, 180, 0.002)])
def test_ricker_within_two_ulp(freq, nt, dt):
    # both compute in float32, but ATen's and XLA's exp may differ by
    # 1 ulp, and the product with (1 - 2a) rounds that input once more:
    # 2 ulp (1 ulp, the first target, fails at a few samples).  In the far
    # tail (|w| < 1e-30) XLA's exp returns 0 where ATen's returns a tiny
    # number, so there the two agree only in absolute terms
    ref = np.asarray(j_ricker(freq, nt, dt))
    got = n(ricker(freq, nt, dt))
    assert got.dtype == np.float32
    body = np.abs(ref) >= 1e-30
    np.testing.assert_array_max_ulp(got[body], ref[body], maxulp=2)
    np.testing.assert_allclose(got[~body], ref[~body], rtol=0, atol=1e-30)


def test_surface_line_equal():
    a = j_surface_line(18, 200, 200)
    b = surface_line(18, 200, 200)
    for f in ("src_z", "src_x", "rcv_z", "rcv_x"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert b.num_shots == 18 and b.num_receivers == 200


@pytest.mark.parametrize("half", [False, True])
def test_sigma_profile_and_damping_within_one_ulp(half):
    ref = np.asarray(j_pml.sigma_profile(60, 20, 15, 10.0, 5000.0,
                                         half_cell=half))
    got = n(pml.sigma_profile(60, 20, 15, 10.0, 5000.0, half_cell=half))
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    np.testing.assert_array_max_ulp(
        n(pml.damping_factors(t(ref), 0.001)),
        np.asarray(j_pml.damping_factors(jnp.asarray(ref), 0.001)),
        maxulp=1)


@pytest.mark.parametrize("free_surface", [False, True])
def test_prepare2_coefficients_within_one_ulp(free_surface):
    grid, cfg, _, vp, _ = acoustic_case()
    grid = dict(grid, free_surface=free_surface)
    jk = j_prepare2(jnp.asarray(vp), jax_acoustic(grid, cfg))
    tk = _prepare2(t(vp), torch_acoustic(grid, cfg))
    assert jk[3] == tk[3]
    for a, b in zip(jk[:3], tk[:3]):
        np.testing.assert_array_max_ulp(n(b), np.asarray(a), maxulp=1)


def test_trace_normalize_and_l1_misfit():
    rng = np.random.default_rng(3)
    d = rng.standard_normal((3, 50, 7)).astype(np.float32)
    d[1, :, 2] = 0.0  # a dead trace: divided by eps only
    o = rng.standard_normal((3, 50, 7)).astype(np.float32)
    # one division per element in both: exact
    np.testing.assert_array_equal(n(trace_normalize(t(d))),
                                  np.asarray(j_trace_normalize(d)))
    # mean of |.|: summation order differs, f32 rounding only
    np.testing.assert_allclose(float(l1_misfit(t(d), t(o))),
                               float(j_l1(jnp.asarray(d), jnp.asarray(o))),
                               rtol=1e-6)


def test_depth_weighting_and_water_mask():
    rng = np.random.default_rng(4)
    grad = rng.standard_normal((30, 20)).astype(np.float32)
    model = np.where(rng.random((30, 20)) < 0.3, 1500.0,
                     2500.0).astype(np.float32)
    # row^2 weights are exact small integers; one product per element
    np.testing.assert_array_equal(
        n(gradproc.depth_weighting(t(grad), 2.0)),
        np.asarray(j_gradproc.depth_weighting(jnp.asarray(grad), 2.0)))
    np.testing.assert_array_equal(
        n(gradproc.water_mask(t(grad), t(model), 1500.0)),
        np.asarray(j_gradproc.water_mask(jnp.asarray(grad),
                                         jnp.asarray(model), 1500.0)))


def test_simulate_acoustic_matches_jax_and_golden():
    grid, cfg, wargs, vp, geom = acoustic_case()
    ref = np.asarray(j_simulate(jnp.asarray(vp), j_ricker(*wargs),
                                *map(jnp.asarray, geom),
                                jax_acoustic(grid, cfg)))
    got = simulate_acoustic(t(vp), ricker(*wargs), *map(t, geom),
                            torch_acoustic(grid, cfg))
    # the tolerance of test_golden's _check: 2e-4 of max (f32 rounding
    # over 180 steps of a 4-field leapfrog)
    assert rel_max(got, ref) <= 2e-4
    assert rel_max(got, golden("acoustic_small")["recs"]) <= 2e-4


def test_synthetic_workload_build_matches_jax():
    from physicsbasedfwi2_tpu.data.synthetic import (
        SyntheticAcousticWorkload as JWL)
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        SyntheticAcousticWorkload)
    kw = dict(nz=24, nx=30, dx=10.0, nt=120, dt=0.001, freq=15.0,
              num_shots=2, num_receivers=6, seed=3, water_rows=4)
    a = JWL.build(**kw)
    b = SyntheticAcousticWorkload.build(**kw, device="cpu")
    ref = port_workload(a)
    # the models are the same numpy code: exact
    np.testing.assert_array_equal(n(b.vp_true), n(ref.vp_true))
    np.testing.assert_array_equal(n(b.vp_start), n(ref.vp_start))
    assert b.acq == ref.acq
    # obs: the first-order propagator, 2e-4 of max as above
    assert rel_max(b.obs, ref.obs) <= 2e-4
    assert rel_max(b.obs_norm, ref.obs_norm) <= 2e-4
    for x, y in zip(b.geom, a.geom):
        np.testing.assert_array_equal(n(x), np.asarray(y))
