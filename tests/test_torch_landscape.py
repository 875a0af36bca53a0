"""The port's ``landscape/`` against the JAX package's on the same numpy
inputs: VTP bytes, filter-normalized directions, surfaces, Hessian-vector
products, Lanczos, trajectory PCA and the CLI; and the two loops the
landscape runs through, ``simulate_acoustic``'s explicit-parameter scan
and the differentiable ring forward.

Each physics case builds the port's engine at a small size, carries its
generator weights to the JAX generator with the converter
(``params_to_flax``: no Flax init) and gives the JAX CLI's physics loss
(``physicsbasedfwi2_tpu/landscape/cli.py``) the engine's own arrays: net
inputs, observed gathers, wavelet and geometry.
"""

import dataclasses
import io
import json
import os
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu import landscape as jland
from physicsbasedfwi2_tpu.engine.engines import EngineBase as JEngineBase
from physicsbasedfwi2_tpu.landscape import projection as jproj
from physicsbasedfwi2_tpu.landscape.vtp import surface_to_vtp as j_vtp
from physicsbasedfwi2_tpu.models import (
    apply_elastic_output as j_aeo, apply_generator as j_apply,
    apply_velocity_output as j_avo, define_generator as j_define,
)
from physicsbasedfwi2_tpu.ops import (
    simulate_acoustic as j_sim, trace_normalize as j_tn,
)
from physicsbasedfwi2_tpu.ops.pallas_elastic_fused import (
    simulate_elastic_ring as j_ring,
)
from physicsbasedfwi2_tpu_torch import landscape
from physicsbasedfwi2_tpu_torch.data.synthetic import (
    SyntheticAcousticWorkload, SyntheticElasticWorkload,
)
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine.engines import (
    AcousticDIPEngine, ElasticDIPEngine,
)
from physicsbasedfwi2_tpu_torch.geo import ricker
from physicsbasedfwi2_tpu_torch.landscape import cli, projection
from physicsbasedfwi2_tpu_torch.landscape.vtp import surface_to_vtp
from physicsbasedfwi2_tpu_torch.models.convert import (
    params_from_flax, params_to_flax,
)
from physicsbasedfwi2_tpu_torch.ops import acoustic, trace_normalize
from physicsbasedfwi2_tpu_torch.ops import elastic_fused as ef

from torch_parity import (
    acoustic_case, elastic_case, jax_acoustic, jax_elastic, n, rel_l2,
    rel_max, torch_acoustic, torch_elastic,
)

torch.set_num_threads(1)

AC = dict(nz=32, nx=40, dx=10.0, nt=100, dt=0.001, pml_width=10, freq=15.0,
          num_shots=2, num_receivers=8)
EL = dict(nz=36, nx=48, dx=15.0, nt=64, dt=0.0015, pml_width=8, freq=20.0,
          num_shots=2, num_receivers=10, water_rows=4, chunk=16)
XS = np.linspace(-0.3, 0.3, 3)
YS = np.linspace(-0.2, 0.4, 3)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# JAX's direction draw, compiled once (eagerly it compiles every leaf's
# operations on their own)
_jdir = jax.jit(jland.filter_normalized_direction)


def _j(x):
    return jnp.asarray(n(x))


def _port(tree) -> dict:
    """A Flax-layout tree (params, direction) as the port's dict."""
    return params_from_flax(_np_tree(tree))


def _flat(tree: dict, keys=None) -> torch.Tensor:
    return torch.cat([tree[k].reshape(-1) for k in (keys or tree)])


def _params(pe) -> dict:
    return {k: w.detach() for k, w in pe.net.named_parameters()}


def _grid(cfg) -> dict:
    g = cfg.grid
    return dict(nz=g.nz, nx=g.nx, dx=g.dx, nt=g.nt, dt=g.dt,
                pml_width=g.pml_width, free_surface=g.free_surface)


@pytest.fixture(scope="module")
def ac_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("landscape_ac")
    cfg = config.get_workload("marmousi_acoustic", **AC, filters=(4, 8),
                              direct_wave=False, validate_on_twin=False,
                              save_dir=str(root / "torch"))
    wl = SyntheticAcousticWorkload.build(**AC, seed=0, water_rows=1,
                                         chunk=cfg.chunk, device="cpu")
    pe = AcousticDIPEngine(cfg, workload=wl, device="cpu")
    jnet = j_define(cfg.netG, out_shape=(cfg.nz, cfg.nx),
                    latent_dim=cfg.latent_dim, filters=cfg.filters,
                    time_decimation=cfg.time_decimation, dropout=cfg.dropout)
    jparams = params_to_flax(pe.net.state_dict(), pe.net)
    jcfg = jax_acoustic(_grid(wl.cfg), dict(chunk=wl.cfg.chunk,
                                            vmax_pml=wl.cfg.vmax_pml))
    wav, geom = _j(wl.wavelet), [_j(a) for a in wl.geom]
    data = {"shots_in": _j(pe.shots_in), "true_b": _j(pe.true_b),
            "obs_norm": _j(wl.obs_norm)}

    def j_loss(params, data):
        # the JAX CLI's acoustic physics loss (landscape/cli.py)
        out = j_apply(jnet, params, data["shots_in"])
        vp = j_avo(out.field, data["true_b"],
                   water_vel=cfg.water_vel)[0, :, :, 0]
        pred = j_sim(vp, wav, *geom, jcfg)
        return jnp.mean((j_tn(pred) - data["obs_norm"]) ** 2)

    return dict(pe=pe, jparams=jparams, j_loss=j_loss, data=data, root=root)


@pytest.fixture(scope="module")
def el_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("landscape_el")
    cfg = config.get_workload("marmousi_elastic", **EL, filters=(4, 8, 16),
                              shots_per_iter=None, freq_stages=(15.0,),
                              save_dir=str(root / "torch"))
    wl = SyntheticElasticWorkload.build(**EL, seed=0, device="cpu")
    pe = ElasticDIPEngine(cfg, workload=wl, device="cpu")
    jnet = j_define(cfg.netG, out_shape=(cfg.nz, cfg.nx),
                    latent_dim=cfg.latent_dim, filters=cfg.filters,
                    time_decimation=cfg.time_decimation, dropout=cfg.dropout,
                    head=cfg.elastic_head)
    jparams = params_to_flax(pe.net.state_dict(), pe.net)
    jcfg = jax_elastic(_grid(wl.cfg), dict(chunk=wl.cfg.chunk,
                                           vmax_pml=wl.cfg.vmax_pml))
    pd = pe._stage_pack(cfg.freq_stages[0])
    geom, rho = [_j(a) for a in wl.geom], _j(wl.start["rho"])
    data = {"in_vx": _j(pe.in_vx), "in_vz": _j(pe.in_vz),
            "lowf": _j(pe.lowf), "true_m": _j(pe.true_m),
            "phys": {k: _j(pd[k]) for k in ("wav", "ovx", "ovz")}}

    def j_loss(params, data):
        # the JAX CLI's elastic physics loss (landscape/cli.py) with the
        # fused path's operator and the tnl1 misfit of
        # ElasticDIPEngine._physics_loss_raw, on every shot
        deltas, _ = jnet.apply(params, data["in_vx"], data["in_vz"],
                               deterministic=True)
        m = j_aeo(deltas, data["lowf"], data["true_m"],
                  delta_scale=pe.delta_scale, clip_min=pe.clip_min,
                  clip_max=pe.clip_max, pin_rows=cfg.water_rows)[0]
        pd = data["phys"]
        pvx, pvz = j_ring(m[..., 0], m[..., 1], rho, pd["wav"], *geom, jcfg)
        return (jnp.mean(jnp.abs(j_tn(pvx) - j_tn(pd["ovx"])))
                + jnp.mean(jnp.abs(j_tn(pvz) - j_tn(pd["ovz"]))))

    assert cfg.misfit == "tnl1" and pe._use_fused
    return dict(pe=pe, jparams=jparams, j_loss=j_loss, data=data, root=root)


def _run(request, which):
    return request.getfixturevalue(f"{which}_run")


def _cut_loss(pe, nt):
    """``cli.physics_loss(pe, differentiable=True)`` with the misfit's
    time loop cut to its first ``nt`` steps: the wavelet and observed
    gathers cut, the acoustic ones normalized again over the cut; the
    generator still reads the full gathers."""
    decode, misfit, data = cli.physics_loss(pe, differentiable=True)
    wl = pe.wl
    cfg = dataclasses.replace(wl.cfg, grid=dataclasses.replace(wl.cfg.grid,
                                                               nt=nt))
    if pe.cfg.engine == "elastic_dip":
        idx = torch.arange(pe.cfg.shots_per_iter or pe.cfg.num_shots)
        pd = data["phys"]
        data = dict(data, phys={"wav": pd["wav"][..., :nt],
                                "ovx": pd["ovx"][:, :nt],
                                "ovz": pd["ovz"][:, :nt]})

        def cut(m, d):
            return pe._physics_loss_raw(
                m, idx, d["phys"],
                sim=lambda *a: ef.simulate_elastic_ring_plain(*a[:-1], cfg))
    else:
        data = dict(data, obs_norm=trace_normalize(wl.obs[:, :nt]))

        def cut(vp, d):
            pred = acoustic.simulate_acoustic(vp, wl.wavelet[..., :nt],
                                              *wl.geom, cfg)
            return torch.mean((trace_normalize(pred) - d["obs_norm"]) ** 2)
    return decode, cut, data


# --- VTP ------------------------------------------------------------------

@pytest.mark.parametrize("shape,kw", [
    ((3, 4), {}),
    ((3, 4), {"log": True, "zmax": 10.0}),
    ((1, 5), {}),
    ((4, 1), {"log": True}),
    ((5, 6), {"zmax": 0.5}),
])
def test_vtp_bytes_match_jax(tmp_path, shape, kw):
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    losses = rng.uniform(0.01, 20.0, shape)
    xs = np.linspace(-1, 1, shape[1])
    ys = np.linspace(-2, 2, shape[0])
    a = surface_to_vtp(str(tmp_path / "port.vtp"), losses, xs, ys, **kw)
    b = j_vtp(str(tmp_path / "jax.vtp"), losses, xs, ys, **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


# --- directions -----------------------------------------------------------

class _Layers(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 5, 3)
        self.up = torch.nn.ConvTranspose2d(4, 6, 2)
        self.fc = torch.nn.Linear(7, 2)
        self.norm = torch.nn.GroupNorm(1, 5)


@pytest.mark.parametrize("norm", ["filter", "layer"])
def test_filter_norms_conv_transpose_dense_and_1d(norm):
    torch.manual_seed(0)
    net = _Layers()
    params = {k: w.detach() for k, w in net.named_parameters()}
    axes = landscape.output_axes(net)
    assert axes == {"conv.weight": 0, "conv.bias": 0, "up.weight": 1,
                    "up.bias": 0, "fc.weight": 0, "fc.bias": 0,
                    "norm.weight": 0, "norm.bias": 0}
    d = landscape.filter_normalized_direction(
        params, torch.Generator().manual_seed(1), norm=norm, out_axes=axes)
    assert d.keys() == params.keys()
    for k, w in params.items():
        if norm == "filter" and w.ndim >= 2:
            ax = axes[k]
            dims = tuple(i for i in range(w.ndim) if i != ax)
            np.testing.assert_allclose(
                n(torch.linalg.vector_norm(d[k], dim=dims)),
                n(torch.linalg.vector_norm(w, dim=dims)), rtol=1e-5,
                err_msg=k)
        else:
            np.testing.assert_allclose(float(torch.linalg.vector_norm(d[k])),
                                       float(torch.linalg.vector_norm(w)),
                                       rtol=1e-5, err_msg=k)
    # without out_axes the weights' names give the conv/dense axis 0
    d2 = landscape.filter_normalized_direction(
        {k: params[k] for k in ("conv.weight", "fc.weight")},
        torch.Generator().manual_seed(1), norm=norm)
    assert torch.equal(d2["conv.weight"], d["conv.weight"])


def test_jax_direction_comes_back_unchanged(ac_run):
    pe = ac_run["pe"]
    dj = _jdir(ac_run["jparams"], jax.random.PRNGKey(4))
    dt = _port(dj)
    params = _params(pe)
    assert dt.keys() == params.keys()
    for axes in (None, landscape.output_axes(pe.net)):
        back = landscape.normalize_direction(dt, params, out_axes=axes)
        for k in params:
            np.testing.assert_allclose(n(back[k]), n(dt[k]), rtol=2e-5,
                                       atol=1e-8, err_msg=k)


# --- the JAX package's quadratic cases --------------------------------------

def _quad(A):
    def loss(p):
        x = p["w"].reshape(-1)
        return 0.5 * x @ A @ x
    return loss


def test_quadratic_surface_matches_jax():
    A = torch.diag(torch.tensor([1.0, 2.0, 3.0, 4.0]))
    params = {"w": torch.zeros((2, 2))}
    xs = ys = np.linspace(-1, 1, 5)
    surf, d1, d2 = landscape.loss_surface_2d(_quad(A), params, xs=xs, ys=ys,
                                             norm="layer", batch=5)
    assert surf.shape == (5, 5)
    assert surf[2, 2] <= surf.min() + 1e-6  # the centre is the minimum
    Aj = jnp.asarray(n(A))
    ref, _, _ = jland.loss_surface_2d(
        lambda p: 0.5 * p["w"].ravel() @ Aj @ p["w"].ravel(),
        {"w": jnp.zeros((2, 2))}, d1={"w": jnp.asarray(n(d1["w"]))},
        d2={"w": jnp.asarray(n(d2["w"]))}, xs=xs, ys=ys, batch=5)
    np.testing.assert_allclose(surf, np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_quadratic_hvp_and_lanczos_match_jax():
    diag = [0.5, 1.0, 2.0, 10.0]
    A = torch.diag(torch.tensor(diag))
    params = {"w": torch.ones((2, 2))}
    v = {"w": torch.tensor([[1.0, 0.0], [0.0, 0.0]])}
    h = landscape.hvp(_quad(A), params, v)
    np.testing.assert_allclose(n(h["w"]).ravel(), [0.5, 0, 0, 0], atol=1e-6)
    Aj = jnp.diag(jnp.asarray(diag))
    jloss = (lambda p: 0.5 * p["w"].ravel() @ Aj @ p["w"].ravel())
    hj = jland.hvp(jloss, {"w": jnp.ones((2, 2))},
                   {"w": jnp.asarray(n(v["w"]))})
    np.testing.assert_allclose(n(h["w"]), np.asarray(hj["w"]), atol=1e-7)
    # decode = the identity: the composite HVP is the generic one
    hc = landscape.composite_hvp(lambda p: p["w"].reshape(-1),
                                 lambda x: 0.5 * x @ A @ x, params, v)
    np.testing.assert_allclose(n(hc["w"]), n(h["w"]), atol=1e-7)
    lo, hi, ritz = landscape.lanczos_extreme_eigs(_quad(A), params, steps=8)
    assert abs(hi - 10.0) < 1e-3 and abs(lo - 0.5) < 1e-3
    jlo, jhi, jritz = jland.lanczos_extreme_eigs(
        jloss, {"w": jnp.ones((2, 2))}, steps=8)
    # the full Krylov space: both give the spectrum
    np.testing.assert_allclose([lo, hi], [jlo, jhi], rtol=1e-5)
    np.testing.assert_allclose(np.sort(ritz), np.sort(jritz), rtol=1e-4)


def test_sharded_surface_waits_for_parallel(tmp_path):
    """Ported with ``parallel/``: on a mesh of one rank the sharded sweep
    (21 points, no pad) equals the one-device sweep to the bit."""
    from torch_parity import one_rank_mesh
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}

    def loss_fn(p):
        return torch.sum(torch.tanh(p["w"]) ** 2) + torch.sum(p["b"] ** 3)

    xs, ys = np.linspace(-1, 1, 7), np.linspace(-1, 1, 3)
    s1, d1, d2 = landscape.loss_surface_2d(loss_fn, params, xs=xs, ys=ys)
    with one_rank_mesh(tmp_path) as mesh:
        s2, e1, _ = landscape.loss_surface_2d_sharded(loss_fn, params, mesh,
                                                      xs=xs, ys=ys)
    assert s2.shape == (3, 7)
    np.testing.assert_array_equal(s2, s1)
    assert all(torch.equal(e1[k], d1[k]) for k in d1)


def test_exports_match_jax():
    assert set(jland.__all__) <= set(landscape.__all__)


# --- the physics surfaces ---------------------------------------------------

@pytest.mark.parametrize("which", ["ac", "el"])
def test_physics_surface_matches_jax(request, which):
    run = _run(request, which)
    pe, jparams = run["pe"], run["jparams"]
    decode, misfit, data = cli.physics_loss(pe)
    surf, d1, d2 = landscape.loss_surface_2d(
        lambda p, d: misfit(decode(p, d), d), _params(pe),
        generator=torch.Generator().manual_seed(7), xs=XS, ys=YS,
        data=data, batch=4, out_axes=landscape.output_axes(pe.net))
    ref, _, _ = jland.loss_surface_2d(
        run["j_loss"], jparams, d1=params_to_flax(d1, pe.net),
        d2=params_to_flax(d2, pe.net), xs=XS, ys=YS, data=run["data"])
    assert surf.shape == (3, 3) and np.isfinite(surf).all()
    # float32 propagators of 100 (64) steps and the generator: 2e-5
    np.testing.assert_allclose(surf, np.asarray(ref), rtol=2e-5)
    assert np.ptp(surf) > 1e-4 * np.abs(surf).max()


# --- Hessian-vector products ------------------------------------------------

@pytest.mark.parametrize("which", ["ac", "el"])
def test_composite_hvp_matches_jax(request, which):
    run = _run(request, which)
    pe, jparams = run["pe"], run["jparams"]
    params = _params(pe)
    v = landscape.filter_normalized_direction(
        params, torch.Generator().manual_seed(9))
    ref = jax.jit(lambda p, w, d: jland.hvp(lambda q: run["j_loss"](q, d),
                                            p, w))(
        jparams, params_to_flax(v, pe.net), run["data"])
    decode, misfit, data = cli.physics_loss(pe, differentiable=True)
    got = landscape.composite_hvp(lambda q: decode(q, data),
                                  lambda m: misfit(m, data), params, v)
    ref = _port(ref)
    assert got.keys() == ref.keys()
    # second derivatives through float32 propagators and the generator:
    # 1e-3 of the whole vector's norm
    assert float(_flat(ref).norm()) > 0
    assert rel_l2(_flat(got), _flat(ref, got)) <= 1e-3


def test_elastic_generator_hvp_at_registered_widths_float64(monkeypatch):
    """AutoElMar22 at ``marmousi_elastic``'s widths in float64 (a small
    grid): the port's HVP of a smooth function of its deltas equals
    JAX's ``jvp`` of ``grad``, and a central difference of two gradients
    along a unit v at a step that crosses none of the generator's
    leaky-ReLU kinks.  (A step that crosses k kinks adds k jumps of the
    gradient to the difference, and k grows with the step: the error
    stays the same size over step sizes.)"""
    import torch.nn.functional as F
    from physicsbasedfwi2_tpu_torch.models import define_generator
    cfg = config.get_workload("marmousi_elastic")
    assert cfg.netG == "AutoElMar22"
    nt, nr, ns, out = 64, 16, 5, (24, 40)
    kw = dict(latent_dim=cfg.latent_dim, filters=cfg.filters,
              time_decimation=cfg.time_decimation, dropout=cfg.dropout,
              head=cfg.elastic_head)
    net = define_generator(cfg.netG, out_shape=out, in_shape=(nt, nr, ns),
                           generator=torch.Generator().manual_seed(0),
                           **kw).double()
    rng = np.random.default_rng(0)
    xv, xz = (torch.tensor(rng.standard_normal((1, nt, nr, ns)))
              for _ in range(2))
    w = torch.tensor(rng.standard_normal((1, *out, 2)))
    params = {k: a.detach() for k, a in net.named_parameters()}
    gen = torch.Generator().manual_seed(6)
    v = {k: torch.randn(a.shape, generator=gen) for k, a in params.items()}
    nrm = torch.linalg.vector_norm(_flat(v))
    # float32 values (the converter's), carried in float64
    v = {k: (a / nrm).double() for k, a in v.items()}

    def f(p):
        deltas, _ = torch.func.functional_call(net, p, (xv, xz))
        return torch.sum(torch.sin(3.0 * deltas) * w)

    hv = landscape.hvp(f, params, v)
    jnet = j_define(cfg.netG, out_shape=out, **kw)
    with jax.enable_x64(True):
        f64 = _np_tree(params_to_flax(net.state_dict(), net))
        jv = _np_tree(params_to_flax(v, net))
        jx = [jnp.asarray(n(a)) for a in (xv, xz, w)]

        def jf(p):
            deltas, _ = jnet.apply(p, jx[0], jx[1], deterministic=True)
            return jnp.sum(jnp.sin(3.0 * deltas) * jx[2])

        ref = _port(jax.jit(lambda p, u: jland.hvp(jf, p, u))(f64, jv))
    # float64 derivatives, the converter's float32 result: 1e-6
    assert rel_l2(_flat(hv), _flat(ref, hv)) <= 1e-6
    signs = []
    leaky = F.leaky_relu
    monkeypatch.setattr(F, "leaky_relu", lambda x, slope: (
        signs.append(x.detach() > 0), leaky(x, slope))[1])

    def grad(sign, eps=1e-6):
        q = {k: (a + sign * eps * v[k]).requires_grad_()
             for k, a in params.items()}
        gs = torch.autograd.grad(f(q), list(q.values()))
        return torch.cat([g.reshape(-1) for g in gs]) / (2 * eps)

    gp = grad(1.0)
    up, signs[:] = list(signs), []
    gm = grad(-1.0)
    assert len(up) == len(signs) > 0
    assert all(torch.equal(a, b) for a, b in zip(up, signs))
    # float64 central difference across no kink: 1e-6 of the norm
    assert rel_l2(_flat(hv), gp - gm) <= 1e-6


def test_composite_hvp_is_reverse_over_reverse(ac_run, el_run):
    for run, nt in ((ac_run, 30), (el_run, 24)):
        pe = run["pe"]
        decode, misfit, data = _cut_loss(pe, nt)
        params = _params(pe)
        gen = torch.Generator().manual_seed(5)
        v = {k: torch.randn(w.shape, generator=gen) for k, w in params.items()}
        got = landscape.composite_hvp(lambda q: decode(q, data),
                                      lambda m: misfit(m, data), params, v)
        ref = landscape.hvp(lambda q: misfit(decode(q, data), data), params, v)
        # the same derivatives in another order: float32 rounding, 1e-4
        # of the whole vector's norm (the leaves a GroupNorm makes
        # invariant are rounding noise on both sides)
        assert got.keys() == ref.keys()
        assert rel_l2(_flat(got), _flat(ref, got)) <= 1e-4


def test_composite_hvp_float64_central_difference(ac_run):
    pe = ac_run["pe"]
    decode, misfit, data = _cut_loss(pe, 60)
    f64 = torch.float64
    data = {k: a.to(f64) for k, a in data.items()}
    params = {k: w.to(f64) for k, w in _params(pe).items()}
    gen = torch.Generator().manual_seed(6)
    v = {k: torch.randn(w.shape, generator=gen, dtype=f64)
         for k, w in params.items()}
    nrm = torch.linalg.vector_norm(_flat(v))
    v = {k: a / nrm for k, a in v.items()}

    def dec(q):
        return decode(q, data)

    def mis(m):
        return misfit(m, data)

    hv = landscape.composite_hvp(dec, mis, params, v)

    # a step of 1e-7 along a unit v: far below the generator's
    # leaky-ReLU kinks (a step of 1e-6 along a unit-normal v crosses
    # some), far above float64 rounding
    def grad(sign, eps=1e-7):
        q = {k: (w + sign * eps * v[k]).requires_grad_()
             for k, w in params.items()}
        gs = torch.autograd.grad(mis(dec(q)), list(q.values()),
                                 allow_unused=True)
        return [torch.zeros_like(w) if g is None else g / (2 * eps)
                for w, g in zip(q.values(), gs)]

    cd = [a - b for a, b in zip(grad(1.0), grad(-1.0))]
    ref = torch.cat([c.reshape(-1) for c in cd])
    assert float(torch.linalg.vector_norm(ref)) > 0
    # float64 central difference: 1e-6 of the norm
    assert rel_l2(_flat(hv), ref) <= 1e-6


def test_checkpoint_takes_no_dual_input(monkeypatch):
    """Forward over reverse through ``simulate_acoustic`` hands
    ``torch.utils.checkpoint`` no dual tensor (it would keep the tangent
    of every tensor a time step saves outside its hooks, and the
    checkpoint of torch 2.11 saves its inputs with a Function that has
    no forward-mode formula): each chunk runs as one ``_DualChunk``, the
    forward pass records no graph node a time step, and the HVP is
    still reverse over reverse's."""
    import torch.autograd.forward_ad as fwAD
    from physicsbasedfwi2_tpu_torch.ops import scan_utils
    calls, chunks = [], []
    checkpoint = scan_utils.checkpoint
    apply = scan_utils._DualChunk.apply

    def strict(fn, *args, **kw):
        calls.append(fn.__name__)
        assert not any(torch.is_tensor(a)
                       and fwAD.unpack_dual(a).tangent is not None
                       for a in args)
        return checkpoint(fn, *args, **kw)

    def counted(*args):
        chunks.append(1)
        return apply(*args)

    monkeypatch.setattr(scan_utils, "checkpoint", strict)
    monkeypatch.setattr(scan_utils._DualChunk, "apply", counted)
    grid, ccfg, wargs, vp, geom = acoustic_case()
    nt = 60
    grid = dict(grid, nt=nt)
    cfg = dataclasses.replace(torch_acoustic(grid, ccfg), chunk=30)
    wav = ricker(10.0, nt, grid["dt"])
    g = [torch.as_tensor(a) for a in geom]
    gen = torch.Generator().manual_seed(2)
    basis = torch.randn(3, *vp.shape, generator=gen)
    params = {"a": torch.randn(3, generator=gen)}
    v = {"a": torch.randn(3, generator=gen)}

    def decode(p):
        return torch.as_tensor(vp) + 30.0 * torch.tanh(
            torch.einsum("k,kij->ij", p["a"], basis))

    def misfit(m):
        return torch.mean(trace_normalize(
            acoustic.simulate_acoustic(m, wav, *g, cfg)) ** 2)

    got = landscape.composite_hvp(decode, misfit, params, v)
    assert calls == [] and len(chunks) == nt // cfg.chunk
    with fwAD.dual_level():
        m = torch.as_tensor(vp).requires_grad_()
        loss = misfit(fwAD.make_dual(m, torch.ones_like(m)))
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None and node not in seen:
            seen.add(node)
            todo.extend(f for f, _ in node.next_functions)
    # a few nodes a chunk and around the scan (per step: hundreds)
    assert len(seen) < nt
    ref = landscape.hvp(lambda p: misfit(decode(p)), params, v)
    assert rel_l2(got["a"], ref["a"]) <= 1e-4


# --- the loops under the landscape ------------------------------------------

def test_acoustic_explicit_scan_equals_closure_scan(ac_run):
    wl = ac_run["pe"].wl
    vp = wl.vp_true * 0.97
    with torch.no_grad():
        a = acoustic._simulate(vp, wl.wavelet, *wl.geom, wl.cfg,
                               explicit=True)
        b = acoustic._simulate(vp, wl.wavelet, *wl.geom, wl.cfg,
                               explicit=False)
        c = acoustic.simulate_acoustic(vp, wl.wavelet, *wl.geom, wl.cfg)
    assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.parametrize("free_surface", [True, False])
def test_ring_grad_forward_and_gradient(free_surface):
    grid, ecfg, wargs, fields, geom = elastic_case(free_surface)
    cfg = torch_elastic(grid, ecfg)
    wav = ricker(*wargs)
    f = [torch.tensor(np.asarray(a, np.float32)) for a in fields]
    g = [torch.as_tensor(a) for a in geom]
    plain = ef.simulate_elastic_ring_plain(*f, wav, *g, cfg)
    fr = [a.clone().requires_grad_() for a in f]
    got = ef.simulate_elastic_ring_plain(*fr, wav, *g, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    w = [torch.randn(a.shape, generator=torch.Generator().manual_seed(i))
         for i, a in enumerate(got)]
    grads = torch.autograd.grad(sum(torch.sum(a * b) for a, b in zip(got, w)),
                                fr)
    jcfg = jax_elastic(grid, ecfg)
    jw = [jnp.asarray(n(a)) for a in w]

    def jloss(vp, vs, rho):
        vx, vz = j_ring(vp, vs, rho, jnp.asarray(n(wav)),
                        *(jnp.asarray(a) for a in geom), jcfg)
        return jnp.sum(vx * jw[0]) + jnp.sum(vz * jw[1])

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *(jnp.asarray(n(a)) for a in f))
    for a, b in zip(grads, ref):
        # the exact adjoint of 64 float32 steps: 1e-4 of the norm
        assert rel_l2(a, np.asarray(b)) <= 1e-4
    with torch.no_grad():
        f64 = ef.simulate_elastic_ring_plain(*(a.double() for a in f), wav,
                                            *g, cfg)
    assert f64[0].dtype == torch.float64
    assert rel_max(f64[0], plain[0]) <= 1e-4


# --- trajectories -----------------------------------------------------------

def test_trajectory_pca_and_checkpoints_match_jax(ac_run):
    pe, base = ac_run["pe"], ac_run["jparams"]
    jdir = str(ac_run["root"] / "jax_ckpt")
    pdir = os.path.join(pe.cfg.save_dir, pe.cfg.name)
    # the JAX package's writer, on the converted weights
    jwriter = types.SimpleNamespace(params=None, _dir=lambda: jdir)
    jseries = []
    for i, tag in enumerate((10, 20, 30, 40)):
        p = jax.tree_util.tree_map(
            lambda w: w * (1.0 + 0.02 * i) + 0.001 * i * np.sin(w), base)
        jseries.append(p)
        jwriter.params = p
        JEngineBase.save_networks(jwriter, tag)
        pe.net.load_state_dict(_port(p))
        pe.save_networks(tag)
    pe.net.load_state_dict(_port(base))
    template = _params(pe)
    for d in (jdir, pdir):
        tags, series = projection.load_checkpoint_series(d, template)
        assert tags == [10, 20, 30, 40]
        for got, ref in zip(series, jseries):
            ref = _port(ref)
            assert list(got) == list(template)
            for k in template:
                np.testing.assert_array_equal(got[k], n(ref[k]), err_msg=k)
    coords, explained, comps = projection.trajectory_pca(series)
    jc, jexp, _ = jproj.trajectory_pca(jseries)
    np.testing.assert_allclose(explained, jexp, rtol=1e-5)
    # a component's sign is the SVD's choice
    signs = np.sign(np.sum(coords * jc, axis=0))
    np.testing.assert_allclose(coords * signs, jc, rtol=1e-4,
                               atol=1e-5 * np.abs(jc).max())
    np.testing.assert_allclose(coords[-1], 0.0, atol=1e-6)
    proj = projection.project_trajectory(series, comps)
    np.testing.assert_allclose(proj, coords, rtol=1e-4,
                               atol=1e-5 * np.abs(coords).max())
    d = projection.unflatten_like(comps[0], template)
    assert {k: tuple(a.shape) for k, a in d.items()} == {
        k: tuple(a.shape) for k, a in template.items()}
    with pytest.raises(ValueError):
        projection.unflatten_like(comps[0][:-1], template)
    with pytest.raises(FileNotFoundError):
        projection.load_checkpoint_series(str(ac_run["root"]), template)


# --- the CLI ----------------------------------------------------------------

TINY = {"nz": 32, "nx": 40, "nt": 60, "dt": 0.001, "pml_width": 10,
        "freq": 15.0,
        "num_shots": 2, "num_receivers": 8, "filters": (4, 8),
        "direct_wave": False, "chunk": 25, "validate_on_twin": False}
TINY_EL = {"nz": 36, "nx": 48, "dx": 15.0, "nt": 64, "dt": 0.0015,
           "pml_width": 8, "freq": 20.0, "num_shots": 2,
           "num_receivers": 10, "water_rows": 4, "chunk": 16,
           "filters": (4, 8, 16), "shots_per_iter": None,
           "freq_stages": (15.0,)}


def _main(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = cli.main(argv)
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out == res
    return out


def _sets(fields):
    return [f"--set={k}={v!r}" for k, v in fields.items()]


@pytest.mark.parametrize("workload,fields,steps", [
    ("marmousi_acoustic", TINY, 2), ("marmousi_elastic", TINY_EL, 1)])
def test_port_cli_surface_vtp_h5_hessian_on_cpu(monkeypatch, tmp_path,
                                                 workload, fields, steps):
    import h5py
    import xml.etree.ElementTree as ET
    lanczos = landscape.lanczos_extreme_eigs
    calls = []

    def fewer_steps(*args, **kw):
        # the CLI's 10 Lanczos HVPs, cut for the test's time
        calls.append(kw["steps"])
        return lanczos(*args, **dict(kw, steps=steps))

    monkeypatch.setattr(landscape, "lanczos_extreme_eigs", fewer_steps)
    out = _main(["--workload", workload, "--device", "cpu", "--x=-0.3:0.3:3",
                 "--y=-0.3:0.3:3", "--vtp", "--h5", "--hessian", "--out",
                 str(tmp_path), "--name", "t", "--save-dir", str(tmp_path)]
                + _sets(fields))
    assert calls == [10]
    assert set(out) == {"min", "max", "center", "eig_min", "eig_max"}
    assert all(np.isfinite(v) for v in out.values())
    assert out["min"] <= out["center"] <= out["max"]
    with np.load(tmp_path / "t_surface.npz") as z:
        surf = z["losses"]
        assert surf.shape == (3, 3)
        np.testing.assert_array_equal(z["xs"], np.linspace(-0.3, 0.3, 3))
    with h5py.File(tmp_path / "t_surface.h5") as f:
        np.testing.assert_array_equal(f["train_loss"][()], surf)
        assert f["xcoordinates"].shape == (3,)
    piece = ET.parse(tmp_path / "t_surface.vtp").getroot().find(
        "PolyData/Piece")
    assert (piece.get("NumberOfPoints"), piece.get("NumberOfPolys")) == (
        "9", "4")
    assert os.path.exists(tmp_path / "t_surface.png")


def test_port_cli_trajectory_on_cpu(tmp_path):
    cfg = config.get_workload("marmousi_acoustic", **TINY,
                              save_dir=str(tmp_path), name="traj_run")
    eng = AcousticDIPEngine(cfg, device="cpu")
    base = {k: w.clone() for k, w in eng.net.state_dict().items()}
    for i, tag in enumerate((10, 20, 30, 40)):
        eng.net.load_state_dict({k: w * (1.0 + 0.02 * i) + 0.001 * i
                                 for k, w in base.items()})
        eng.save_networks(tag)
    out = _main(["--workload", "marmousi_acoustic", "--device", "cpu",
                 "--name", "traj", "--out", str(tmp_path), "--x=-1:1:3",
                 "--y=-1:1:3", "--trajectory", str(tmp_path / "traj_run")]
                + _sets(TINY))
    assert np.isfinite(out["min"])
    with np.load(tmp_path / "traj_surface.npz") as z:
        assert z["traj_coords"].shape == (4, 2)
        assert list(z["traj_epochs"]) == [10, 20, 30, 40]
        # the final checkpoint is the PCA centre
        np.testing.assert_allclose(z["traj_coords"][-1], 0.0, atol=1e-3)
    # the surface is centred on the final checkpoint
    eng.net.load_state_dict({k: w * 1.06 + 0.003 for k, w in base.items()})
    decode, misfit, data = cli.physics_loss(eng)
    with torch.no_grad():
        centre = float(misfit(decode(_params(eng), data), data))
    np.testing.assert_allclose(out["center"], centre, rtol=1e-6)


def test_port_cli_without_a_card_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["--workload", "marmousi_acoustic", "--out", str(tmp_path),
                  "--save-dir", str(tmp_path)] + _sets(TINY))


def test_small_overrides_are_the_jax_clis():
    # the JAX CLI's --small block (landscape/cli.py)
    assert cli.small_overrides(False) == dict(
        nz=48, nx=64, nt=300, num_shots=4, num_receivers=32,
        filters=(4, 8, 16), chunk=25, water_rows=6)
    assert cli.small_overrides(True) == dict(
        nz=48, nx=64, nt=160, num_shots=4, num_receivers=20,
        filters=(4, 8, 16), chunk=25, water_rows=4, dt=0.0015,
        shots_per_iter=2, pml_width=12)

