"""The differentiable "xla" backend of the port against the JAX package
on the CPU (no Pallas kernel on either side): the misfits,
``chunked_checkpoint_scan``, ``simulate_acoustic`` under autograd,
``acoustic_gradient``, the acoustic engine's non-fused path, and the
workload builders' default device.

Tolerances: both sides run the same float32 scheme; only the order of
the sums differs, so values agree to 1e-5 of their max and gradients
(a reverse sweep over every step) to 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu import ops as jops
from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticAcousticWorkload as JWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import AcousticDIPEngine as JEngine
from physicsbasedfwi2_tpu.models import apply_velocity_output as j_avo
from physicsbasedfwi2_tpu.ops.scan_utils import (
    chunked_checkpoint_scan as j_scan,
)
from physicsbasedfwi2_tpu_torch import ops
from physicsbasedfwi2_tpu_torch.data.synthetic import (
    SyntheticAcousticWorkload, SyntheticElasticWorkload,
)
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine.engines import AcousticDIPEngine
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax
from physicsbasedfwi2_tpu_torch.ops.scan_utils import chunked_checkpoint_scan

from torch_parity import jax_acoustic, n, port_workload, rel_l2, rel_max, t
from torch_parity import torch_acoustic

torch.set_num_threads(1)

GRID = dict(nz=20, nx=28, dx=10.0, nt=90, dt=0.001, pml_width=8)
CFG = dict(chunk=16, vmax_pml=3000.0)  # 90 steps: a padded last chunk


def _crosswell(ns=3, nr=5):
    """Sources down column 2, receivers down column 25 (several rows per
    shot), per-shot wavelets; vp and a perturbed observed model."""
    rng = np.random.default_rng(21)
    vp = (1900.0 + 150.0 * rng.standard_normal((20, 28))).astype(np.float32)
    obs_vp = vp.copy()
    obs_vp[8:13, 10:18] += 200.0
    tt = np.arange(GRID["nt"]) * GRID["dt"]
    wav = np.stack([
        (1 - 2 * (np.pi * 25.0 * (tt - 0.04 - 0.002 * s)) ** 2)
        * np.exp(-(np.pi * 25.0 * (tt - 0.04 - 0.002 * s)) ** 2)
        * (1.0 + 0.1 * s) for s in range(ns)]).astype(np.float32)
    src_z = np.linspace(3, 16, ns).astype(np.int32)
    src_x = np.full(ns, 2, np.int32)
    rcv_z = np.tile(np.linspace(2, 17, nr).astype(np.int32), (ns, 1))
    rcv_x = np.full((ns, nr), 25, np.int32)
    return vp, obs_vp, wav, (src_z, src_x, rcv_z, rcv_x)


def _jax_sim(vp, wav, geom):
    return jops.simulate_acoustic(jnp.asarray(vp), jnp.asarray(wav),
                                  *map(jnp.asarray, geom),
                                  jax_acoustic(GRID, CFG))


def _torch_sim(vp, wav, geom):
    return ops.simulate_acoustic(vp, wav, *map(t, geom),
                                 torch_acoustic(GRID, CFG))


# ---------------------------------------------------------------------------
# misfits
# ---------------------------------------------------------------------------

def _traces_with_ties():
    rng = np.random.default_rng(5)
    pred = rng.standard_normal((2, 30, 4)).astype(np.float32)
    obs = rng.standard_normal((2, 30, 4)).astype(np.float32)
    direct = 0.1 * rng.standard_normal((2, 30, 4)).astype(np.float32)
    # trace (0, :, 1) of pred - direct reaches its max |.| three times
    pred[0, :, 1] = np.clip(pred[0, :, 1], -1.0, 1.0)
    pred[0, [4, 11, 20], 1] = [2.5, -2.5, 2.5]
    pred[0, :, 1] += direct[0, :, 1]
    return pred, obs, direct


@pytest.mark.parametrize("kind", ["l1", "l2", "huber"])
def test_plain_misfits_and_gradients_match_jax(kind):
    pred, obs, _ = _traces_with_ties()
    pred = 1.5 * pred  # residuals on both sides of huber's delta
    obs[1, :3, 2] = pred[1, :3, 2]  # zero residuals: |r|' = 1 in JAX
    jfn = {"l1": jops.l1_misfit, "l2": jops.l2_misfit,
           "huber": jops.huber_misfit}[kind]
    tfn = {"l1": ops.l1_misfit, "l2": ops.l2_misfit,
           "huber": ops.huber_misfit}[kind]
    jl, jg = jax.value_and_grad(jfn)(jnp.asarray(pred), jnp.asarray(obs))
    p = t(pred).requires_grad_(True)
    tl = tfn(p, t(obs))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert rel_max(p.grad, jg) <= 1e-6


@pytest.mark.parametrize("kind,fc", [("l1", None), ("l2", None),
                                     ("huber", None), ("l2", 60.0)])
def test_normalized_trace_misfit_matches_jax_with_ties(kind, fc):
    pred, obs, direct = _traces_with_ties()
    obs_norm = np.asarray(jops.trace_normalize(jnp.asarray(obs)))

    def jloss(p):
        return jops.normalized_trace_misfit(
            p, jnp.asarray(obs_norm), jnp.asarray(direct), kind=kind, fc=fc,
            dt=0.004)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(pred))
    p = t(pred).requires_grad_(True)
    tl = ops.normalized_trace_misfit(p, t(obs_norm), t(direct), kind=kind,
                                     fc=fc, dt=0.004)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    # the tied trace's max gets a third of the correction at each tie;
    # one of its residuals is exactly 0, where |r|' is 1, as in JAX
    assert rel_max(p.grad, jg) <= 1e-5


def test_amax_splits_the_gradient_among_ties_like_jnp_max():
    x = np.array([[1.0, -3.0, 3.0, 2.0, 3.0]], np.float32)
    jg = jax.grad(lambda a: jnp.sum(jnp.max(jnp.abs(a), axis=1)))(
        jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    torch.amax(torch.abs(xt), dim=1).sum().backward()
    np.testing.assert_array_equal(n(xt.grad), np.asarray(jg))
    np.testing.assert_allclose(n(xt.grad)[0], [0, -1 / 3, 1 / 3, 0, 1 / 3],
                               rtol=1e-6)


def test_normalized_trace_misfit_low_pass_needs_dt():
    pred, obs, _ = _traces_with_ties()
    with pytest.raises(ValueError, match="fc needs dt"):
        ops.normalized_trace_misfit(t(pred), t(obs), fc=10.0)
    with pytest.raises(ValueError, match="unknown misfit"):
        ops.normalized_trace_misfit(t(pred), t(obs), kind="l3")


# ---------------------------------------------------------------------------
# chunked_checkpoint_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 7, 30])
def test_chunked_checkpoint_scan_matches_jax(chunk):
    """Values, the carry after the zero-padded last chunk, and the
    gradients w.r.t. the initial carry and the inputs."""
    rng = np.random.default_rng(chunk)
    a0, b0 = rng.standard_normal((2, 3)).astype(np.float32)
    xs = rng.standard_normal((30, 3)).astype(np.float32)

    def jstep(c, x):
        a, b = c
        a2 = 0.9 * a + jnp.sin(b) * x
        return (a2, b - 0.1 * a2 * a2), a2 * b

    def tstep(c, x):
        a, b = c
        (x,) = x
        a2 = 0.9 * a + torch.sin(b) * x
        return (a2, b - 0.1 * a2 * a2), a2 * b

    def jloss(a, b, x):
        (ca, cb), ys = j_scan(jstep, (a, b), x, chunk=chunk)
        return jnp.sum(ys ** 2) + jnp.sum(ca * cb), (ca, cb, ys)

    (jl, (jca, jcb, jys)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(a0), jnp.asarray(b0), jnp.asarray(xs))
    ta, tb, tx = (t(v).requires_grad_(True) for v in (a0, b0, xs))
    (ca, cb), ys = chunked_checkpoint_scan(tstep, (ta, tb), (tx,),
                                           chunk=chunk)
    tl = torch.sum(ys ** 2) + torch.sum(ca * cb)
    tl.backward()
    assert ys.shape == (30, 3)
    assert rel_max(ys, jys) <= 1e-5
    assert rel_max(ca, jca) <= 1e-5 and rel_max(cb, jcb) <= 1e-5
    for got, ref in zip((ta.grad, tb.grad, tx.grad), jgrads):
        assert rel_max(got, ref) <= 1e-4


def test_chunked_checkpoint_scan_without_grad_keeps_no_graph():
    x = torch.ones(10, 2, requires_grad=True)
    with torch.no_grad():
        (c,), ys = chunked_checkpoint_scan(
            lambda c, xt: ((c[0] + xt[0],), c[0] * 2.0),
            (torch.zeros(2),), (x,), chunk=4)
    assert not ys.requires_grad and not c.requires_grad
    # the carry runs over the two zero-padded steps as well
    np.testing.assert_array_equal(n(c), [10.0, 10.0])
    np.testing.assert_array_equal(n(ys[:, 0]), 2.0 * np.arange(10))


# ---------------------------------------------------------------------------
# simulate_acoustic under autograd and acoustic_gradient
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def crosswell():
    vp, obs_vp, wav, geom = _crosswell()
    obs = _jax_sim(obs_vp, wav, geom)
    return vp, wav, geom, np.asarray(obs)


def test_simulate_acoustic_crosswell_forward_matches_jax(crosswell):
    vp, wav, geom, _ = crosswell
    ref = _jax_sim(vp, wav, geom)
    got = _torch_sim(t(vp), t(wav), geom)
    assert got.shape == ref.shape == (3, GRID["nt"], 5)
    assert rel_max(got, ref) <= 1e-5


@pytest.mark.parametrize("kind", ["l2", "normalized_l1"])
def test_simulate_acoustic_gradients_match_jax_grad(crosswell, kind):
    """dJ/dvp and dJ/dwavelet (per-shot wavelets, multi-row receivers)
    against ``jax.grad`` through the JAX scan."""
    vp, wav, geom, obs = crosswell
    obs_norm = np.asarray(jops.trace_normalize(jnp.asarray(obs)))

    def jloss(v, w):
        pred = jops.simulate_acoustic(v, w, *map(jnp.asarray, geom),
                                      jax_acoustic(GRID, CFG))
        if kind == "l2":
            return jnp.mean((pred - obs) ** 2)
        return jops.normalized_trace_misfit(pred, jnp.asarray(obs_norm))

    jl, (jgv, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(vp), jnp.asarray(wav))
    v, w = t(vp).requires_grad_(True), t(wav).requires_grad_(True)
    pred = _torch_sim(v, w, geom)
    if kind == "l2":
        tl = torch.mean((pred - t(obs)) ** 2)
    else:
        tl = ops.normalized_trace_misfit(pred, t(obs_norm))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert rel_max(v.grad, jgv) <= 1e-4
    assert rel_max(w.grad, jgw) <= 1e-4
    assert float(torch.abs(w.grad).max()) > 0.0


def test_acoustic_gradient_matches_jax(crosswell):
    vp, wav, geom, obs = crosswell
    obs_norm = np.asarray(jops.trace_normalize(jnp.asarray(obs)))
    jl, jg = jops.acoustic_gradient(
        jnp.asarray(vp),
        lambda p: jops.normalized_trace_misfit(p, jnp.asarray(obs_norm),
                                               kind="l2"),
        jnp.asarray(wav), *map(jnp.asarray, geom), jax_acoustic(GRID, CFG))
    tl, tg = ops.acoustic_gradient(
        t(vp), lambda p: ops.normalized_trace_misfit(p, t(obs_norm),
                                                     kind="l2"),
        t(wav), *map(t, geom), torch_acoustic(GRID, CFG))
    assert not tl.requires_grad and not tg.requires_grad
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert rel_max(tg, jg) <= 1e-4


def test_simulate_acoustic_directional_fd_float64(crosswell):
    """<dJ/dvp, d> against a central difference of J in float64 (the
    same discrete problem without float32 rounding): rel-err <= 1e-3."""
    vp, wav, geom, obs = crosswell
    rng = np.random.default_rng(4)
    d = torch.tensor(rng.standard_normal(vp.shape))
    vp64, wav64, obs64 = (torch.tensor(a, dtype=torch.float64)
                          for a in (vp, wav, obs))

    def loss(v):
        return torch.mean((_torch_sim(v, wav64, geom) - obs64) ** 2)

    v = vp64.clone().requires_grad_(True)
    loss(v).backward()
    assert v.grad.dtype == torch.float64
    h = 1.0  # m/s against ~2000 m/s
    with torch.no_grad():
        fd = (loss(vp64 + h * d) - loss(vp64 - h * d)) / (2 * h)
    ad = torch.sum(v.grad * d)
    assert abs(float(ad - fd)) <= 1e-3 * abs(float(fd))


# ---------------------------------------------------------------------------
# the acoustic engine's "xla" path
# ---------------------------------------------------------------------------

SIZE = dict(nz=32, nx=40, dx=10.0, nt=400, dt=0.001, freq=15.0,
            num_shots=3, num_receivers=8)


def _flax_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def xla_engines(tmp_path_factory):
    """The JAX engine on its default CPU path and the port's "xla" path
    on one workload with the same generator weights; the processed
    physics gradient at the initial model, then three Adam steps."""
    root = tmp_path_factory.mktemp("xla_engines")
    kw = dict(**SIZE, filters=(4, 8), backend="xla")
    jcfg = j_config.get_workload("marmousi_acoustic", **kw,
                                 save_dir=str(root / "jax"))
    cfg = config.get_workload("marmousi_acoustic", **kw,
                              save_dir=str(root / "torch"))
    jwl = JWorkload.build(**SIZE, seed=0, water_rows=1)
    # the engines subtract the direct wave from their workload's obs:
    # the port's copy is taken before the JAX engine does so
    pwl = port_workload(jwl)
    je = JEngine(jcfg, workload=jwl)
    pe = AcousticDIPEngine(cfg, workload=copy.copy(pwl), device="cpu")
    pe.net.load_state_dict(params_from_flax(_flax_np(je.params)))
    out = dict(je=je, pe=pe, pwl=pwl)
    physics_loss, pd = je._make_physics_loss()
    vp = j_avo(je._apply_net(je.params).field, je.true_b,
               water_vel=jcfg.water_vel)[0, :, :, 0]
    jl, jg = jax.value_and_grad(physics_loss)(vp, pd)
    vpt = t(vp).requires_grad_()
    tl = pe.physics_loss(vpt)
    tl.backward()
    out["physics"] = (float(jl), np.asarray(jg), float(tl.detach()),
                      n(vpt.grad))
    out["true"] = (float(physics_loss(je.wl.vp_true, pd)),
                   float(pe.physics_value_and_grad(pe.wl.vp_true)[0]))
    out["steps"] = [(je.optimize_parameters(ep), pe.optimize_parameters(ep))
                    for ep in (1, 2, 3)]
    return out


def test_xla_engine_path_and_direct_wave(xla_engines):
    je, pe = xla_engines["je"], xla_engines["pe"]
    assert pe.physics_path == je.physics_path == "xla"
    assert pe._dir_rows is None and je._dir_rows is None
    # simulate_acoustic of the constant model over 400 steps
    assert rel_max(pe._direct, je._direct) <= 1e-5
    assert rel_max(pe.wl.obs_norm, je.wl.obs_norm) <= 2e-5
    # the synthetic obs come from the same operator: zero misfit
    jtrue, ptrue = xla_engines["true"]
    assert jtrue <= 1e-6 and ptrue <= 1e-6


def test_xla_engine_processed_gradient_matches(xla_engines):
    jl, jg, tl, tg = xla_engines["physics"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tg.shape == jg.shape
    # the L1 signs of the few residuals within rounding of zero may
    # differ: 1e-3 rel L2, as on the fused path
    assert rel_l2(tg, jg) <= 1e-3
    assert np.all(tg[0] == 0.0)  # the water row is masked


def test_xla_engine_three_adam_steps_match(xla_engines):
    for jrec, prec in xla_engines["steps"]:
        assert jrec.keys() == prec.keys() == {"loss_D", "loss_M_MSE", "lr"}
        for k in jrec:
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-4,
                                       err_msg=k)


def test_xla_path_is_taken_for_each_reason(xla_engines, capsys):
    pe = xla_engines["pe"]
    for kw, why in ((dict(backend="xla"), "backend=xla"),
                    (dict(backend="auto", misfit="l2"), "misfit=l2")):
        e = AcousticDIPEngine(pe.cfg.replace(**kw),
                              workload=copy.copy(xla_engines["pwl"]),
                              device="cpu")
        assert e.physics_path == "xla"
        assert f"fused unavailable: {why}" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the workload builders' default device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("builder", [SyntheticAcousticWorkload,
                                     SyntheticElasticWorkload])
def test_workload_builders_default_to_the_card(monkeypatch, builder):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card.*device=\"cpu\""):
        builder.build(nz=12, nx=16, nt=20, num_shots=1, num_receivers=2)
