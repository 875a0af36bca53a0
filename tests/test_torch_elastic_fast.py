"""The port's differentiable elastic propagators against the JAX package:
the 5-field sponge scheme (``ops/elastic_fast.py``:
``simulate_elastic_fast``, ``elastic_illumination``) and the split-PML
scheme (``ops/elastic.py``: ``simulate_elastic``, ``elastic_gradient``),
forward traces and the trace-normalized L2 (``tnl2``) gradient, on the
same numpy inputs made from a seed (40 x 60 cells, nt 200, 3 shots).
Both are plain autograd through ``chunked_checkpoint_scan``; one
directional finite difference in float64 checks the port's gradient on
its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.ops import elastic as j_elastic
from physicsbasedfwi2_tpu.ops import elastic_fast as j_fast
from physicsbasedfwi2_tpu.ops.misfit import trace_normalize as j_tn
from physicsbasedfwi2_tpu_torch.data.synthetic import (
    make_elastic_model, make_marmousi_like, smooth_model,
)
from physicsbasedfwi2_tpu_torch.ops import elastic_gradient, simulate_elastic
from physicsbasedfwi2_tpu_torch.ops.elastic_fast import (
    elastic_illumination, simulate_elastic_fast,
)
from physicsbasedfwi2_tpu_torch.ops.misfit import trace_normalize

from torch_parity import jax_elastic, rel_l2, rel_max, t, torch_elastic

torch.set_num_threads(1)

NZ, NX, NT, NS, NR, WATER = 40, 60, 200, 3, 12, 4
CFG = dict(chunk=25, vmax_pml=4000.0)


def _grid(free_surface: bool):
    return dict(nz=NZ, nx=NX, dx=15.0, nt=NT, dt=0.0015, pml_width=8,
                free_surface=free_surface)


def _geometry(kind: str):
    """(src_z, src_x, rcv_z, rcv_x) int32: one receiver row below the
    water, receivers on varying rows ("multirow"), or pairs of receivers
    in one column ("dupcols")."""
    rng = np.random.default_rng(3)
    src_z = np.full(NS, WATER + 1, np.int32)
    src_x = np.array([8, 30, 51], np.int32)
    rcv_x = np.tile(np.linspace(2, NX - 3, NR).astype(np.int32), (NS, 1))
    rcv_z = np.full((NS, NR), WATER + 1, np.int32)
    if kind == "multirow":
        rcv_z = rng.integers(1, NZ - 2, (NS, NR)).astype(np.int32)
    elif kind == "dupcols":
        rcv_x = np.repeat(rcv_x[:, : NR // 2], 2, axis=1)
        rcv_z[:, 1::2] = WATER + 6
    return src_z, src_x, rcv_z, rcv_x


def _models():
    """(true (vp, vs, rho), smooth start (vp, vs, rho)) as float32 numpy."""
    vp = make_marmousi_like(NZ, NX, seed=2, water_rows=WATER)
    true = make_elastic_model(vp, water_rows=WATER)
    start = tuple(smooth_model(m, preserve_rows=WATER) for m in true)
    return true, start


def _wavelet():
    from physicsbasedfwi2_tpu_torch.geo import ricker
    return ricker(12.0, NT, 0.0015).numpy()


def _j_tnl2(pred, obs):
    return sum(jnp.mean((j_tn(p) - j_tn(o)) ** 2)
               for p, o in zip(pred, obs))


def _t_tnl2(pred, obs):
    return sum(torch.mean((trace_normalize(p) - trace_normalize(o)) ** 2)
               for p, o in zip(pred, obs))


SCHEMES = {"fast": (j_fast.simulate_elastic_fast, simulate_elastic_fast),
           "pml": (j_elastic.simulate_elastic, simulate_elastic)}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("kind,free", [("single", True), ("single", False),
                                       ("multirow", True),
                                       ("dupcols", True)])
def test_traces_match_jax(scheme, kind, free):
    jsim, tsim = SCHEMES[scheme]
    (vp, vs, rho), _ = _models()
    wav, geom = _wavelet(), _geometry(kind)
    jcfg, tcfg = jax_elastic(_grid(free), CFG), torch_elastic(_grid(free), CFG)
    jvx, jvz = jsim(*(jnp.asarray(a) for a in (vp, vs, rho, wav)),
                    *(jnp.asarray(g) for g in geom), jcfg)
    with torch.no_grad():
        tvx, tvz = tsim(*(t(a) for a in (vp, vs, rho, wav)),
                        *(t(g) for g in geom), tcfg)
    assert tvx.shape == tvz.shape == (NS, NT, NR) == jvx.shape
    assert tvx.dtype == torch.float32
    assert float(np.abs(np.asarray(jvx)).max()) > 0
    assert rel_max(tvx, jvx) <= 1e-5
    assert rel_max(tvz, jvz) <= 1e-5
    if kind == "dupcols":
        # the two receivers of a column sit on different rows
        assert not torch.equal(tvx[..., 0], tvx[..., 1])


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("kind", ["single", "multirow"])
def test_tnl2_gradient_matches_jax(scheme, kind):
    jsim, tsim = SCHEMES[scheme]
    true, start = _models()
    wav, geom = _wavelet(), _geometry(kind)
    jcfg, tcfg = jax_elastic(_grid(True), CFG), torch_elastic(_grid(True), CFG)
    jgeom = [jnp.asarray(g) for g in geom]
    tgeom = [t(g) for g in geom]
    jobs = jsim(*(jnp.asarray(a) for a in true), jnp.asarray(wav), *jgeom,
                jcfg)
    with torch.no_grad():
        tobs = tsim(*(t(a) for a in true), t(wav), *tgeom, tcfg)
    rho = start[2]

    def jloss(vp, vs):
        return _j_tnl2(jsim(vp, vs, jnp.asarray(rho), jnp.asarray(wav),
                            *jgeom, jcfg), jobs)

    jl, (jgp, jgs) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(start[0]), jnp.asarray(start[1]))
    vp, vs = (t(a).requires_grad_(True) for a in start[:2])
    tl = _t_tnl2(tsim(vp, vs, t(rho), t(wav), *tgeom, tcfg), tobs)
    tgp, tgs = torch.autograd.grad(tl, (vp, vs))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(jnp.abs(jgp).max()) > 0 and float(jnp.abs(jgs).max()) > 0
    assert rel_l2(tgp, jgp) <= 1e-4
    assert rel_l2(tgs, jgs) <= 1e-4


def test_elastic_gradient_matches_jax():
    """``elastic_gradient`` (split PML) with respect to all three fields,
    and with respect to a subset."""
    true, start = _models()
    wav, geom = _wavelet(), _geometry("single")
    jcfg, tcfg = jax_elastic(_grid(True), CFG), torch_elastic(_grid(True), CFG)
    jobs = j_elastic.simulate_elastic(
        *(jnp.asarray(a) for a in true), jnp.asarray(wav),
        *(jnp.asarray(g) for g in geom), jcfg)
    with torch.no_grad():
        tobs = simulate_elastic(*(t(a) for a in true), t(wav),
                                *(t(g) for g in geom), tcfg)
    jl, jg = j_elastic.elastic_gradient(
        *(jnp.asarray(a) for a in start), lambda p: _j_tnl2(p, jobs),
        jnp.asarray(wav), *(jnp.asarray(g) for g in geom), jcfg)
    tl, tg = elastic_gradient(*(t(a) for a in start),
                              lambda p: _t_tnl2(p, tobs), t(wav),
                              *(t(g) for g in geom), tcfg)
    assert set(tg) == set(jg) == {"vp", "vs", "rho"}
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in tg:
        assert not tg[k].requires_grad
        assert rel_l2(tg[k], jg[k]) <= 1e-4, k
    tl2, tg2 = elastic_gradient(*(t(a) for a in start),
                                lambda p: _t_tnl2(p, tobs), t(wav),
                                *(t(g) for g in geom), tcfg, wrt=("vs",))
    assert set(tg2) == {"vs"} and float(tl2) == float(tl)
    assert torch.equal(tg2["vs"], tg["vs"])


@pytest.mark.parametrize("free", [True, False])
def test_illumination_matches_jax(free):
    _, start = _models()
    wav, (sz, sx, _, _) = _wavelet(), _geometry("single")
    jcfg = jax_elastic(_grid(free), CFG)
    tcfg = torch_elastic(_grid(free), CFG)
    ref = j_fast.elastic_illumination(
        *(jnp.asarray(a) for a in start), jnp.asarray(wav), jnp.asarray(sz),
        jnp.asarray(sx), jcfg)
    got = elastic_illumination(*(t(a) for a in start), t(wav), t(sz), t(sx),
                               tcfg)
    assert got.shape == (NZ, NX) and not got.requires_grad
    assert float(jnp.min(ref)) >= 0 and float(jnp.max(ref)) > 0
    assert rel_max(got, ref) <= 1e-5


def test_fast_gradient_matches_finite_difference():
    """<dJ/dm, d> against the central difference of J along a random
    smooth direction d over vp and vs, in float64 (the port alone)."""
    true, start = _models()
    wav, geom = _wavelet(), _geometry("single")
    cfg = torch_elastic(_grid(True), CFG)
    f64 = [t(a, torch.float64) for a in start]
    tgeom = [t(g) for g in geom]
    w64 = t(wav, torch.float64)
    with torch.no_grad():
        obs = simulate_elastic_fast(*(t(a, torch.float64) for a in true),
                                    w64, *tgeom, cfg)
    rng = np.random.default_rng(11)
    dirs = [torch.as_tensor(smooth_model(
        rng.standard_normal((NZ, NX)).astype(np.float32), iters=10),
        dtype=torch.float64) * s for s in (40.0, 25.0)]
    for d in dirs:
        d[:WATER + 1] = 0.0

    def loss(vp, vs):
        return _t_tnl2(simulate_elastic_fast(vp, vs, f64[2], w64, *tgeom,
                                             cfg), obs)

    vp, vs = (a.clone().requires_grad_(True) for a in f64[:2])
    gp, gs = torch.autograd.grad(loss(vp, vs), (vp, vs))
    ad = float((gp * dirs[0]).sum() + (gs * dirs[1]).sum())
    eps = 1e-3
    with torch.no_grad():
        fd = (float(loss(f64[0] + eps * dirs[0], f64[1] + eps * dirs[1]))
              - float(loss(f64[0] - eps * dirs[0], f64[1] - eps * dirs[1]))
              ) / (2 * eps)
    assert ad != 0.0
    assert abs(fd - ad) / abs(ad) <= 1e-3, (fd, ad)
