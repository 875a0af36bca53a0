"""Born modeling (ops/born.py) against the JAX package: ``born_acoustic``
on the JAX test's case (tests/test_born_ganfwi.py:
40 x 50, nt 250, 2 shots), its background equal to ``simulate_acoustic``,
its scattered data to JAX's ``jax.jvp`` and to a central difference;
``born_elastic`` against JAX at a tiny elastic shape; the reverse-mode
path of the scan untouched by it."""

import jax.numpy as jnp
import numpy as np
import torch

from physicsbasedfwi2_tpu.geo import (
    Grid2D as JGrid, ricker as j_ricker, surface_line as j_surface_line,
)
from physicsbasedfwi2_tpu.ops import (
    AcousticConfig as JConfig, simulate_elastic as j_simulate_elastic,
)
from physicsbasedfwi2_tpu.ops.born import (
    born_acoustic as j_born_acoustic, born_elastic as j_born_elastic,
)
from physicsbasedfwi2_tpu_torch.geo import Grid2D
from physicsbasedfwi2_tpu_torch.ops import AcousticConfig, simulate_acoustic
from physicsbasedfwi2_tpu_torch.ops.born import born_acoustic, born_elastic
from physicsbasedfwi2_tpu_torch.ops.elastic import simulate_elastic

from torch_parity import elastic_case, jax_elastic, n, rel_max, t, \
    torch_elastic

torch.set_num_threads(1)

GRID = dict(nz=40, nx=50, dx=10.0, nt=250, dt=0.002, pml_width=14)


def _acoustic():
    """The JAX test's case in both packages: (port args, JAX args)."""
    acq = j_surface_line(2, 20, 50, src_depth=2, rcv_depth=2)
    geom = [np.asarray(a) for a in (acq.src_z, acq.src_x, acq.rcv_z,
                                    acq.rcv_x)]
    vp = np.full((40, 50), 1800.0, np.float32)
    dvp = np.zeros_like(vp)
    dvp[22:28, 20:35] = 1.0
    jcfg = JConfig(grid=JGrid(**GRID), chunk=25, vmax_pml=2500.0)
    cfg = AcousticConfig(grid=Grid2D(**GRID), chunk=25, vmax_pml=2500.0)
    jwav = j_ricker(10.0, GRID["nt"], GRID["dt"])
    # one wavelet for both (the packages' ricker differ by ~3e-8)
    port = (t(vp), t(dvp), t(jwav), *(t(a) for a in geom), cfg)
    jx = (jnp.asarray(vp), jnp.asarray(dvp), jwav,
          *(jnp.asarray(a) for a in geom), jcfg)
    return port, jx


def test_born_acoustic_matches_jax_and_linearizes():
    (vp, dvp, wav, *geom, cfg), jargs = _acoustic()
    bg, scat = born_acoustic(vp, dvp, wav, *geom, cfg)
    jbg, jscat = j_born_acoustic(*jargs)
    assert bg.shape == scat.shape == (2, 250, 20)
    assert not bg.requires_grad and not scat.requires_grad
    # the background is simulate_acoustic's own forward (rtol 1e-5, as
    # the JAX test holds its own)
    with torch.no_grad():
        plain = simulate_acoustic(vp, wav, *geom, cfg)
    np.testing.assert_allclose(n(bg), n(plain), rtol=1e-5,
                               atol=1e-5 * float(plain.abs().max()))
    # against jax.jvp: float32 over 250 steps, 1e-5 of max
    assert rel_max(bg, jbg) <= 1e-5
    assert rel_max(scat, jscat) <= 1e-5
    # first order in the perturbation: a central difference within 5 %
    # of max (the JAX test's bound)
    eps = 2.0
    with torch.no_grad():
        fd = (simulate_acoustic(vp + eps * dvp, wav, *geom, cfg)
              - simulate_acoustic(vp - eps * dvp, wav, *geom, cfg)) / (
            2 * eps)
    assert float((fd - scat).abs().max() / scat.abs().max()) < 0.05


def test_born_acoustic_is_linear_and_leaves_reverse_mode_alone():
    (vp, dvp, wav, *geom, cfg), _ = _acoustic()
    _, s1 = born_acoustic(vp, dvp, wav, *geom, cfg)
    _, s3 = born_acoustic(vp, -3.0 * dvp, wav, *geom, cfg)
    # float32 rounding of the scaled tangent: 1e-5 of max
    np.testing.assert_allclose(n(s3), -3.0 * n(s1), rtol=1e-5,
                               atol=1e-5 * float(s1.abs().max()))
    # the reverse-mode gradient through the checkpointed scan: <dJ/dvp,
    # dvp> of J = <recs, w> equals <scattered, w>
    w = torch.randn(s1.shape, generator=torch.Generator().manual_seed(0))
    v = vp.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(
        (simulate_acoustic(v, wav, *geom, cfg) * w).sum(), v)
    np.testing.assert_allclose(float((g * dvp).sum()),
                               float((s1 * w).sum()), rtol=1e-4)


def test_born_elastic_matches_jax():
    grid, ecfg, wav_args, model, geom = elastic_case(free_surface=False)
    vp, vs, rho = model
    rng = np.random.default_rng(1)
    dvp = np.zeros_like(vp)
    dvs = np.zeros_like(vs)
    dvp[18:24, 16:32] = 50.0
    dvs[20:26, 12:30] = rng.uniform(10, 30, (6, 18)).astype(np.float32)
    jcfg, cfg = jax_elastic(grid, ecfg), torch_elastic(grid, ecfg)
    wav = np.asarray(j_ricker(*wav_args))
    (jbx, jbz), (jsx, jsz) = j_born_elastic(
        *(jnp.asarray(a) for a in (vp, vs, rho, dvp, dvs, wav)),
        *(jnp.asarray(a) for a in geom), jcfg)
    (bx, bz), (sx, sz) = born_elastic(
        *(t(a) for a in (vp, vs, rho, dvp, dvs, wav)),
        *(t(a) for a in geom), cfg)
    # float32 over 64 steps of the split-PML scheme: 1e-5 of max
    for got, ref in ((bx, jbx), (bz, jbz), (sx, jsx), (sz, jsz)):
        assert got.shape == ref.shape == (2, 64, 10)
        assert rel_max(got, ref) <= 1e-5
    with torch.no_grad():
        px, pz = simulate_elastic(*(t(a) for a in (vp, vs, rho, wav)),
                                  *(t(a) for a in geom), cfg)
    assert torch.equal(px, bx) and torch.equal(pz, bz)
    jx, _ = j_simulate_elastic(*(jnp.asarray(a) for a in (vp, vs, rho, wav)),
                               *(jnp.asarray(a) for a in geom), jcfg)
    assert rel_max(bx, jx) <= 1e-5
