"""BASELINE config 4 (``latent_inversion``): the port's VAE pretraining,
``LatentInversionEngine`` and ``GanFWI`` against the JAX package's on the
same numpy inputs and Flax weights.

The random streams differ between the packages (numpy's shuffle is the
one shared): the pretraining's latent noise is drawn by the JAX loop
under its step keys and handed to the port through
``models/vae.py::latent_noise``; GanFWI's SGLD runs at temperature 0 on
both sides.  The JAX engine's ``save_networks`` raises (it has no
``params``, ROADMAP Queue C); the port saves and restores ``z``.
"""

import dataclasses
import functools
import os
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticAcousticWorkload as JWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine import ganfwi as j_ganfwi
from physicsbasedfwi2_tpu.engine import pretrain as j_pretrain
from physicsbasedfwi2_tpu.engine.engines import (
    LatentInversionEngine as JLatent,
)
from physicsbasedfwi2_tpu.models import ModelVae as JModelVae
from physicsbasedfwi2_tpu_torch.engine import config, ganfwi, pretrain
from physicsbasedfwi2_tpu_torch.engine.engines import LatentInversionEngine
from physicsbasedfwi2_tpu_torch.engine.test import evaluate
from physicsbasedfwi2_tpu_torch.engine.train import train
from physicsbasedfwi2_tpu_torch.models import vae
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax
from physicsbasedfwi2_tpu_torch.optim import sgmcmc

from torch_parity import n, port_workload, rel_max, t

torch.set_num_threads(1)

# tests/test_engine.py's SMALL_AC
SMALL_AC = dict(nz=40, nx=48, nt=400, dt=0.001, num_shots=4,
                num_receivers=24, filters=(4, 8, 16), chunk=25,
                water_rows=6, pml_width=12)


def _flax_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _zero_bias(name: str) -> bool:
    """A conv bias in front of a one-channel GroupNorm group: a zero
    gradient, which both frameworks return as rounding noise and Adam
    turns into +-lr steps; the net's output does not depend on it."""
    return re.search(r"convs\.\d+\.bias$", name) is not None


def test_make_model_bank_matches_jax():
    got = pretrain.make_model_bank(3, 20, 24, water_rows=4, seed=3)
    ref = j_pretrain.make_model_bank(3, 20, 24, water_rows=4, seed=3)
    assert got.shape == (3, 20, 24) and np.array_equal(got, ref)


def test_pretrain_first_two_steps_match_flax():
    """Two Adam steps (one epoch of two batches) from Flax's init with
    the JAX loop's latent noise: the epoch's mean reconstruction MSE and
    the weights after it."""
    bank = j_pretrain.make_model_bank(8, 16, 20, water_rows=3, seed=3)
    kw = dict(latent_dim=4, filters=(4, 8), epochs=1, batch_size=4,
              lr=2e-3, seed=0)
    jnet, jparams, jnorm, jhist = j_pretrain.pretrain_model_vae(bank, **kw)
    # the JAX loop's init and, per step, the noise under its step key
    vmin, vmax = float(bank.min()), float(bank.max())
    x01 = jnp.asarray((bank - vmin) / (vmax - vmin + 1e-12))[..., None]
    key = jax.random.PRNGKey(0)
    jm = JModelVae(out_shape=(16, 20), latent_dim=4, filters=(4, 8))
    p0 = jm.init({"params": key, "latent": key}, x01[:1])
    rng, noise = jax.random.PRNGKey(1), []
    normal = jax.random.normal

    def record(*args, **kwargs):
        out = normal(*args, **kwargs)
        noise.append(t(out))
        return out

    for _ in range(2):
        rng, sub = jax.random.split(rng)
        with mock.patch.object(jax.random, "normal", record):
            jm.apply(p0, x01[:4], deterministic=False, rngs={"latent": sub})
    assert len(noise) == 2

    def flax_init(**k):
        net = vae.ModelVae(**k)
        net.load_state_dict(params_from_flax(_flax_np(p0)))
        return net

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pretrain, "ModelVae", flax_init)
        mp.setattr(vae, "latent_noise", lambda shape, generator: noise.pop(0))
        net, norm, hist = pretrain.pretrain_model_vae(bank, **kw,
                                                      device="cpu")
    assert not noise and norm == jnorm
    np.testing.assert_allclose(hist, jhist, rtol=1e-5)
    jp = params_from_flax(_flax_np(jparams))
    pp = net.state_dict()
    assert jp.keys() == pp.keys()
    keep = [k for k in jp if not _zero_bias(k)]
    num = sum(float(((pp[k] - jp[k]) ** 2).sum()) for k in keep)
    den = sum(float((jp[k] ** 2).sum()) for k in keep)
    assert (num / den) ** 0.5 <= 1e-3
    z = np.random.default_rng(1).standard_normal((2, 4)).astype(np.float32)
    with torch.no_grad():
        got = net.decode(t(z))
    ref = jnet.apply(jparams, jnp.asarray(z), method=jnet.decode)
    assert rel_max(got, ref) <= 1e-4


@pytest.fixture(scope="module")
def jwl():
    return JWorkload.build(nz=40, nx=48, nt=400, dt=0.001, num_shots=4,
                           num_receivers=24, chunk=25, water_rows=6,
                           pml_width=12, seed=0)


def _latent_pair(jwl, root, decoder_norm=None):
    kw = dict(SMALL_AC, save_dir=str(root))
    jcfg = j_config.get_workload("latent_inversion", **kw).replace(
        name="jax")
    cfg = config.get_workload("latent_inversion", **kw).replace(name="torch")
    je = JLatent(jcfg, workload=dataclasses.replace(jwl),
                 decoder_norm=decoder_norm)
    pe = LatentInversionEngine(cfg, workload=port_workload(jwl),
                               decoder_norm=decoder_norm, device="cpu")
    pe.net.load_state_dict(params_from_flax(_flax_np(je.decoder_params)))
    return je, pe


@pytest.mark.parametrize("decoder_norm", [None, (1500.0, 4200.0)])
def test_latent_three_adam_steps_match_jax(jwl, tmp_path, decoder_norm):
    je, pe = _latent_pair(jwl, tmp_path, decoder_norm)
    assert pe.physics_path == "xla"
    assert not any(p.requires_grad for p in pe.net.parameters())
    assert list(pe.params) == ["z"] and pe.params["z"].shape == (1, 8)
    for ep in (1, 2, 3):
        jrec, prec = je.optimize_parameters(ep), pe.optimize_parameters(ep)
        assert jrec.keys() == prec.keys() == {"loss_D_MSE", "loss_M_MSE",
                                              "lr"}
        for k in jrec:
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5,
                                       err_msg=f"epoch {ep} {k}")
        assert rel_max(pe.params["z"], je.z) <= 1e-4
    (jv, jm), (pv, pm) = je.test(), pe.test()
    np.testing.assert_allclose(pv["loss_V_MSE"], jv["loss_V_MSE"],
                               rtol=1e-5)
    assert rel_max(pm, jm) <= 1e-5


def test_latent_save_defect_jax_raises_port_restores_z(jwl, tmp_path):
    """The JAX engine has no ``params``, so its save (and train()'s save
    at the last epoch) raises; the port writes ``z`` under ``['z']`` and
    restores it, and train() and evaluate() finish."""
    je, pe = _latent_pair(jwl, tmp_path)
    je.optimize_parameters(1)
    with pytest.raises(AttributeError, match="params"):
        je.save_networks("latest")
    engine, hist = train(pe.cfg, epochs=2, engine=pe, quiet=True)
    path = os.path.join(pe._dir(), "latest_net_G.npz")
    with np.load(path) as z:
        assert z.files == ["['z']"]
        saved = z["['z']"]
    z_end = n(pe.params["z"])
    assert np.array_equal(saved, z_end) and np.abs(z_end).max() > 0
    with torch.no_grad():
        pe.params["z"].zero_()
    pe.load_networks("latest")
    assert np.array_equal(n(pe.params["z"]), z_end)
    # a fresh engine (evaluate's) restores z from the checkpoint
    got = evaluate(pe.cfg, workload=port_workload(jwl), device="cpu",
                   results_dir=str(tmp_path / "res"))
    fresh = LatentInversionEngine(pe.cfg, workload=port_workload(jwl),
                                  device="cpu")
    fresh.load_networks("latest")
    assert np.array_equal(n(fresh.params["z"]), z_end)
    assert np.isfinite(got["loss_V_MSE"])
    with pytest.raises(ValueError, match="lbfgs"):
        LatentInversionEngine(pe.cfg.replace(optimizer="lbfgs"),
                              workload=port_workload(jwl), device="cpu")


def test_ganfwi_at_temperature_zero_matches_jax(jwl):
    """SGLD at temperature 0 is gradient descent: the chains' losses and
    models agree step for step (physics, well and prior terms)."""
    nz, nx = 40, 48
    basis = np.random.default_rng(2).standard_normal(
        (8, nz * nx)).astype(np.float32)
    base = np.asarray(jwl.vp_start)

    # (bounds the chain never reaches: at a tie jnp.clip passes half the
    # gradient, torch.clamp all of it)
    def j_decode(z):
        return jnp.clip(base + 200.0 * (z @ basis).reshape(nz, nx),
                        1000.0, 6000.0)

    def p_decode(z, b=t(basis), v0=t(base)):
        return torch.clamp(v0 + 200.0 * (z @ b).reshape(nz, nx),
                           1000.0, 6000.0)

    kw = dict(sampler="sgld", lr=5e-4, lambda_prior=1e-2, lambda_well=1e-6,
              well_cols=[5, 30])
    with pytest.MonkeyPatch.context() as mp:
        from physicsbasedfwi2_tpu.optim import sgmcmc as j_sgmcmc
        mp.setattr(j_ganfwi, "sgld", functools.partial(j_sgmcmc.sgld,
                                                       temperature=0.0))
        mp.setattr(ganfwi, "sgld", functools.partial(sgmcmc.sgld,
                                                     temperature=0.0))
        jg = j_ganfwi.GanFWI(j_decode, 8, dataclasses.replace(jwl), **kw)
        pg = ganfwi.GanFWI(p_decode, 8, port_workload(jwl), **kw)
    jl, js = jg.sample(4, burn_in=1, thin=2)
    pl, ps = pg.sample(4, burn_in=1, thin=2)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert ps.shape == js.shape == (2, nz, nx)
    assert rel_max(ps, js) <= 1e-5
    assert rel_max(pg.z, jg.z) <= 1e-4
    assert pg.opt.generator.device == pg.z.device
    m = torch.full((10, 12), 2000.0)
    truth = m.clone()
    truth[:, 3] = 2500.0
    assert float(ganfwi.well_loss(m, truth, torch.tensor([3]))) > 0
    assert float(ganfwi.well_loss(truth, truth, torch.tensor([3]))) == 0
    assert float(ganfwi.prior_loss(torch.zeros(1, 8))) == 0
