"""BASELINE config 2 and its siblings on the acoustic engine
(``marmousi_acoustic_unet``, ``_vae``, ``_nf``, ``_vaeflow``): the port's
AcousticDIPEngine against the JAX engine built with
``extras={"fused_interpret": True}``, on one numpy workload and the same
generator weights, over two free-running Adam steps with the loss terms
of each family (KL, the planar flows' log-det, AutoNF's latent NLL).
Adam's first step is lr * sign(gradient), so a weight whose gradient is
within the two packages' difference of zero steps +-lr apart.  Besides
the conv biases in front of one-channel GroupNorm groups (left out of the
comparison), that is a few elements: in the U-Net 4 of its weights,
whose gradient is ~1e-3 of their leaf's largest or less, in the
VaeNormalizingPhy net 9 of its decoder's Dense, ~1e-6.  Between the steps
those elements alone take the JAX engine's weights and Adam moments.

A VAE's training decode samples its latent.  The JAX engine's noise for
a step is drawn under the step's key; the test draws it the same way
outside the jitted step (``jax.random.normal`` recorded) and hands it to
the port through ``vae.latent_noise``.
"""

import dataclasses
import json
import os
import re
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticAcousticWorkload as JWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import AcousticDIPEngine as JEngine
from physicsbasedfwi2_tpu.models import (
    apply_velocity_output as j_avo, define_generator as j_define,
)
from physicsbasedfwi2_tpu.models.vae import kl_divergence as j_kl
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine import train as t_train
from physicsbasedfwi2_tpu_torch.engine.engines import AcousticDIPEngine
from physicsbasedfwi2_tpu_torch.models import (
    apply_velocity_output, define_generator, kl_divergence, vae,
)
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax
from physicsbasedfwi2_tpu_torch.optim import SGLD

from torch_parity import n, port_workload, rel_max, t

torch.set_num_threads(1)

# tests/test_torch_engine.py's size (one water row, see its docstring)
SIZE = dict(nz=32, nx=40, dx=10.0, nt=400, dt=0.001, freq=15.0,
            num_shots=3, num_receivers=8)
ZOO = ["marmousi_acoustic_unet", "marmousi_acoustic_vae",
       "marmousi_acoustic_nf", "marmousi_acoustic_vaeflow"]


def _flax_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jwl():
    return JWorkload.build(**SIZE, seed=0, water_rows=1)


def _engines(name, jwl, root, **overrides):
    """The JAX and the port engine of workload ``name`` on copies of
    ``jwl`` (each engine rewrites its workload's observed data), the port
    generator loaded with the JAX one's weights."""
    jcfg = j_config.get_workload(
        name, **SIZE, filters=(4, 8), save_dir=str(root / "jax"),
        extras={"fused_interpret": True}, **overrides)
    cfg = config.get_workload(name, **SIZE, filters=(4, 8),
                              save_dir=str(root / "torch"), **overrides)
    pe = AcousticDIPEngine(cfg, workload=port_workload(jwl), device="cpu")
    je = JEngine(jcfg, workload=dataclasses.replace(jwl))
    pe.net.load_state_dict(params_from_flax(_flax_np(je.params)))
    return je, pe


def _zero_bias(name: str) -> bool:
    """A conv bias in front of a one-channel GroupNorm group: its gradient
    is zero, which both frameworks return as rounding noise and Adam turns
    into +-lr steps (tests/test_torch_engine.py); the net's output does not
    depend on it."""
    return re.search(r"convs\.\d+\.bias$", name) is not None


def _resync_flipped(pe, je):
    """After the first Adam step: the elements (outside the zero-gradient
    biases) whose step went the other way in the two engines take the JAX
    engine's weight and Adam moments.  Returns {leaf: (elements, their
    largest |gradient| over the leaf's largest)}."""
    jp = params_from_flax(_flax_np(je.params))
    adam = je.opt_state.inner_state[0]
    mu, nu = (params_from_flax(_flax_np(m)) for m in (adam.mu, adam.nu))
    flipped = {}
    with torch.no_grad():
        for name, p in pe.net.named_parameters():
            flip = (p - jp[name]).abs() > pe.cfg.lr
            if _zero_bias(name) or not flip.any():
                continue
            g = p.grad.abs()
            flipped[name] = (int(flip.sum()),
                             float(g[flip].max() / g.max()))
            p[flip] = jp[name][flip]
            state = pe.opt.state[p]
            state["exp_avg"][flip] = mu[name][flip]
            state["exp_avg_sq"][flip] = nu[name][flip]
    return flipped


def _jax_step_noise(je):
    """The latent noise the JAX engine's next step draws: its net applied
    under the step's key (the split ``optimize_parameters`` makes next),
    with ``jax.random.normal`` recorded."""
    _, sub = jax.random.split(je._rng)
    draws = []
    normal = jax.random.normal

    def record(*args, **kw):
        out = normal(*args, **kw)
        draws.append(np.asarray(out))
        return out

    with mock.patch.object(jax.random, "normal", record):
        je._apply_net(je.params, deterministic=False, rng=sub)
    assert len(draws) == 1
    return draws[0]


@pytest.fixture(scope="module", params=ZOO)
def zoo_run(request, jwl, tmp_path_factory):
    """Two Adam steps of both engines from the same weights, a VAE's noise
    of each step the JAX engine's own; between them only the elements
    whose first step went the other way are resynced."""
    je, pe = _engines(request.param, jwl, tmp_path_factory.mktemp("zoo"))
    steps, flipped = [], {}
    with pytest.MonkeyPatch.context() as mp:
        for ep in (1, 2):
            if ep == 2:
                flipped = _resync_flipped(pe, je)
            if pe.is_vae:
                eps = t(_jax_step_noise(je))
                mp.setattr(vae, "latent_noise",
                           lambda shape, generator, e=eps: e)
            steps.append((je.optimize_parameters(ep),
                          pe.optimize_parameters(ep)))
    with torch.no_grad():
        field = pe.net(pe.shots_in)[0]
    return dict(
        name=request.param, je=je, pe=pe, steps=steps, flipped=flipped,
        params=(params_from_flax(_flax_np(je.params)),
                {k: v.detach().clone()
                 for k, v in pe.net.state_dict().items()}),
        vp=(np.asarray(j_avo(je._apply_net(je.params).field, je.true_b)),
            n(apply_velocity_output(field, pe.true_b))))


def test_two_adam_steps_match_jax(zoo_run):
    je, pe = zoo_run["je"], zoo_run["pe"]
    assert pe.physics_path == "fused-plain" and je.physics_path == "fused"
    assert pe.is_vae == je.is_vae == ("vae" in zoo_run["name"])
    for jrec, prec in zoo_run["steps"]:
        assert jrec.keys() == prec.keys() == {"loss_D", "loss_M_MSE", "lr"}
        for k in jrec:
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5,
                                       err_msg=k)
    jp, pp = zoo_run["params"]
    assert jp.keys() == pp.keys()
    # the elements resynced after the first step: few, each with a
    # gradient within the packages' difference of zero
    n_params = sum(v.numel() for v in pp.values())
    assert sum(c for c, _ in zoo_run["flipped"].values()) <= 1e-3 * n_params
    assert all(r <= 2e-3 for _, r in zoo_run["flipped"].values())
    # the zero-gradient biases are left out; the net's output does not
    # depend on them and is compared below
    keep = [k for k in pp if not _zero_bias(k)]
    num = sum(float(((pp[k] - jp[k]) ** 2).sum()) for k in keep)
    den = sum(float((jp[k] ** 2).sum()) for k in keep)
    assert (num / den) ** 0.5 <= 1e-3
    jv, pv = zoo_run["vp"]
    assert rel_max(pv, jv) <= 1e-3


def test_loss_terms_of_each_family(zoo_run):
    """Without the physics (and lstart 0) the loss is the family's own
    term alone: kl_weight * KL for the VAEs (minus the mean log-det with
    planar flows), flow_weight * (0.5 |z|^2 - log|det|) for AutoNF, none
    for the U-Net."""
    pe, name = zoo_run["pe"], zoo_run["name"]
    cfg = pe.cfg
    with torch.no_grad():
        loss, _ = pe._total_loss(False)
        out = pe.net(pe.shots_in)
    if name == "marmousi_acoustic_unet":
        assert out[1] is None and float(loss) == 0.0
        return
    if pe.is_vae:
        mu, logvar = out[1], out[2]
        want = kl_divergence(mu, logvar)
        if name.endswith("vaeflow"):
            want = want - torch.mean(out[4])
        want = cfg.kl_weight * want
    else:
        z, logdet = out[1], out[2]
        want = cfg.flow_weight * (0.5 * torch.mean(torch.sum(z ** 2, -1))
                                  - torch.mean(logdet))
    assert float(want) != 0.0
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)


def test_vae_test_is_deterministic_and_training_draws_noise(zoo_run):
    pe = zoo_run["pe"]
    if not pe.is_vae:
        assert pe._latent_gen is None
        return
    (va, ma), (vb, mb) = pe.test(), pe.test()
    assert va == vb and np.array_equal(ma, mb)
    gen = pe._latent_gen
    assert gen.device == pe.device
    with torch.no_grad():
        a, b = (pe.net(pe.shots_in, deterministic=False, generator=gen)[0]
                for _ in range(2))
    assert not torch.equal(a, b)


def test_checkpoints_cross_packages(zoo_run):
    """A ``<tag>_net_G.npz`` saved by either engine loads in the other,
    bit for bit (the setup()-style VAEs name their submodules by
    attribute, the compact nets by type)."""
    je, pe = zoo_run["je"], zoo_run["pe"]
    pe.save_networks("from_torch")
    os.makedirs(je._dir(), exist_ok=True)
    shutil.copy(os.path.join(pe._dir(), "from_torch_net_G.npz"),
                os.path.join(je._dir(), "from_torch_net_G.npz"))
    je.load_networks("from_torch")
    jp = params_from_flax(_flax_np(je.params))
    for k, v in pe.net.state_dict().items():
        assert torch.equal(jp[k], v), k
    je.save_networks("from_jax")
    shutil.copy(os.path.join(je._dir(), "from_jax_net_G.npz"),
                os.path.join(pe._dir(), "from_jax_net_G.npz"))
    pe.load_networks("from_jax")
    for k, v in pe.net.state_dict().items():
        assert torch.equal(jp[k], v), k


def test_lbfgs_probes_reuse_the_step_latent_noise(jwl, tmp_path):
    """Under L-BFGS every line-search probe of a step decodes with the
    step's latent noise (the JAX engine's value_fn reuses the step's
    key); the next step draws new noise."""
    cfg = config.get_workload("marmousi_acoustic_vae", **SIZE, filters=(4, 8),
                              save_dir=str(tmp_path), optimizer="lbfgs")
    pe = AcousticDIPEngine(cfg, workload=port_workload(jwl), device="cpu")
    draws = []
    real = vae.latent_noise

    def record(shape, generator):
        e = real(shape, generator)
        draws.append(e.clone())
        return e

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vae, "latent_noise", record)
        counts = []
        for ep in (1, 2):
            pe.optimize_parameters(ep)
            counts.append(len(draws))
    first, second = draws[:counts[0]], draws[counts[0]:]
    assert counts[0] == pe.opt.evaluations or counts[0] >= 2
    assert all(torch.equal(e, first[0]) for e in first)
    assert all(torch.equal(e, second[0]) for e in second)
    assert not torch.equal(first[0], second[0])


def test_sgld_step_of_marmousi_acoustic(jwl, tmp_path):
    """One SGLD step of marmousi_acoustic: the loss is the JAX engine's
    from the same weights (taken before the update), and the update is
    -lr * gradient plus noise of std sqrt(2 lr)."""
    je, pe = _engines("marmousi_acoustic", jwl, tmp_path, optimizer="sgld")
    assert isinstance(pe.opt, SGLD) and pe.lr_policy is None
    before = {k: v.detach().clone() for k, v in pe.net.named_parameters()}
    jrec, prec = je.optimize_parameters(1), pe.optimize_parameters(1)
    assert prec.keys() == jrec.keys() == {"loss_D", "loss_M_MSE"}
    for k in jrec:
        np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5, err_msg=k)
    lr = pe.cfg.lr
    noise = torch.cat([(p.detach() - before[k] + lr * p.grad).ravel()
                       for k, p in pe.net.named_parameters()])
    assert abs(float(noise.std()) / (2 * lr) ** 0.5 - 1) < 0.02
    # the noise stream starts from the seed: a fresh engine from the same
    # weights reproduces the update
    pe2 = AcousticDIPEngine(pe.cfg, workload=port_workload(jwl),
                            device="cpu")
    pe2.net.load_state_dict({**pe2.net.state_dict(), **before})
    pe2.optimize_parameters(1)
    for k, p in pe2.net.named_parameters():
        assert torch.equal(p, dict(pe.net.named_parameters())[k]), k


def test_vae_first_adam_step_at_full_width_matches_jax():
    """The registered VAE recipe at full input width ([1, 4001, 200, 18],
    filters (16, 32, 64, 128)): one Adam step at lr 0.01 of kl_weight * KL
    from the same weights moves every logvar by ~140 in both packages.
    Adam's first step is lr * sign(g), and the Dense kernel's gradient is
    feature_i * dL/dlogvar_j, so the Dense alone moves each logvar by
    lr * (sum_i |feature_i| + 1) over the ~95k features, whatever the
    loss; the loss sets only its sign.  On the card, with the physics
    term too, the port's logvar passes 2 ln(FLT_MAX) ~ 177 and exp(logvar
    / 2) overflows at the second epoch (PERF.md §6)."""
    x = np.random.default_rng(0).standard_normal((1, 4001, 200, 18)).astype(
        np.float32)
    jcfg = j_config.get_workload("marmousi_acoustic_vae")
    jnet = j_define(jcfg.netG, out_shape=(jcfg.nz, jcfg.nx))
    params = jax.jit(jnet.init)({"params": jax.random.PRNGKey(0)},
                                jnp.asarray(x))

    def kl(p):
        _, mu, logvar, _ = jnet.apply(p, jnp.asarray(x))
        return jcfg.kl_weight * j_kl(mu, logvar)

    opt = optax.adam(jcfg.lr, b1=jcfg.beta1, eps=jcfg.adam_eps)
    upd, _ = opt.update(jax.jit(jax.grad(kl))(params), opt.init(params),
                        params)
    params1 = optax.apply_updates(params, upd)
    _, _, jlv0, _ = jax.jit(jnet.apply)(params, jnp.asarray(x))
    _, _, jlv1, _ = jax.jit(jnet.apply)(params1, jnp.asarray(x))
    cfg = config.get_workload("marmousi_acoustic_vae")
    net = define_generator(cfg.netG, out_shape=(cfg.nz, cfg.nx),
                           in_shape=x.shape[1:])
    net.load_state_dict(params_from_flax(_flax_np(params)))
    topt = torch.optim.Adam(net.parameters(), lr=cfg.lr,
                            betas=(cfg.beta1, 0.999), eps=cfg.adam_eps)
    feats = []
    net.encoder.fc.register_forward_hook(
        lambda m, args, out: feats.append(args[0].detach().clone()))
    _, mu, logvar, _ = net(t(x))
    (cfg.kl_weight * kl_divergence(mu, logvar)).backward()
    topt.step()
    with torch.no_grad():
        lv1 = net(t(x))[2]
        dense_move = net.encoder.fc(feats[0]).chunk(2, dim=-1)[1] - logvar
    l1 = cfg.lr * (float(feats[0].abs().sum()) + 1)
    np.testing.assert_allclose(n(dense_move.abs()), l1, rtol=1e-2)
    assert np.abs(np.asarray(jlv0)).max() < 2
    assert np.abs(np.asarray(jlv1)).min() > 100
    np.testing.assert_allclose(n(lv1), np.asarray(jlv1), rtol=1e-3)


def test_cli_trains_unet22_on_cpu(tmp_path, capsys):
    t_train.main(["--workload", "marmousi_acoustic", "--netG", "Unet22",
                  "--small", "--device", "cpu", "--epochs", "2",
                  "--save-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "acoustic physics path: fused-plain" in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["epoch"] == 2 and rec["loss_D"] > 0
    assert all(np.isfinite(v) for v in rec.values() if isinstance(v, float))
    assert (tmp_path / "marmousi_acoustic" / "latest_net_G.npz").exists()
