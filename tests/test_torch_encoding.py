"""Simultaneous-source encoding: the port's ``ops/encoding.py`` against
the JAX package's, and the acoustic engine's ``encoded_shots`` path
(``marmousi_acoustic_encoded``) against the JAX engine's.

The two packages draw their encodings from different generators
(``torch.Generator`` against ``jax.random`` keys), so the comparisons
hand the port the JAX draws: ``encoded_fwi_gradient``'s ``groups``/``pol``
and the engine's per-step ``encoding``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticAcousticWorkload as JWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import AcousticDIPEngine as JEngine
from physicsbasedfwi2_tpu.ops import encoding as j_enc
from physicsbasedfwi2_tpu.ops import simulate_acoustic as j_sim
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine.engines import AcousticDIPEngine
from physicsbasedfwi2_tpu_torch.geo import ricker, surface_line
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax
from physicsbasedfwi2_tpu_torch.ops import encoding, simulate_acoustic

from torch_parity import (
    jax_acoustic, port_workload, rel_l2, rel_max, t, torch_acoustic,
)

torch.set_num_threads(1)

# tests/test_encoding.py's case
GRID = dict(nz=36, nx=48, dx=10.0, nt=200, dt=0.002, pml_width=12)
CFG = dict(chunk=25, vmax_pml=2500.0)


def _case(ns):
    acq = surface_line(ns, 16, 48, src_depth=2, rcv_depth=2)
    geom = tuple(np.asarray(a) for a in
                 (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    vp = np.full((36, 48), 1800.0, np.float32)
    vp[18:28, 15:35] += 150.0 * np.random.default_rng(4).random((10, 20))
    return geom, vp


@pytest.mark.parametrize("ns,n_super", [(4, 2), (5, 2), (6, 3)])
def test_encode_shots_partitions_with_rademacher_polarities(ns, n_super):
    gen = torch.Generator().manual_seed(ns)
    groups, pol = encoding.encode_shots(ns, n_super, gen)
    k = -(-ns // n_super)
    assert groups.shape == pol.shape == (n_super, k)
    assert groups.dtype == torch.int64 and pol.dtype == torch.float32
    flat, pflat = groups.flatten().tolist(), pol.flatten().tolist()
    assert sorted(flat[:ns]) == list(range(ns))  # every shot once
    assert all(abs(p) == 1.0 for p in pflat[:ns])
    # the padded duplicates are silent
    assert all(p == 0.0 for p in pflat[ns:])
    again = encoding.encode_shots(ns, n_super,
                                  torch.Generator().manual_seed(ns))
    assert all(torch.equal(a, b) for a, b in zip(again, (groups, pol)))


def test_encoded_simulation_is_the_polarity_weighted_sum():
    """A super-shot equals the polarity-weighted sum of its member
    shots' ``simulate_acoustic``, and the JAX super-shot on the same
    encoding."""
    geom, vp = _case(4)
    cfg = torch_acoustic(GRID, CFG)
    wav = ricker(10.0, GRID["nt"], GRID["dt"])
    tgeom = tuple(torch.as_tensor(a) for a in geom)
    groups, pol = encoding.encode_shots(4, 2, torch.Generator().manual_seed(0))
    with torch.no_grad():
        per_shot = simulate_acoustic(t(vp), wav, *tgeom, cfg)
        enc = encoding.simulate_acoustic_encoded(
            t(vp), wav, tgeom[0][groups], tgeom[1][groups], pol,
            tgeom[2][:1].expand(2, -1), tgeom[3][:1].expand(2, -1), cfg)
    expect = torch.einsum("gk,gktr->gtr", pol, per_shot[groups])
    assert enc.shape == (2, GRID["nt"], 16)
    assert rel_max(enc, expect) <= 1e-5
    g, p = np.asarray(groups), np.asarray(pol)
    jenc = j_enc.simulate_acoustic_encoded(
        jnp.asarray(vp), jnp.asarray(wav.numpy()), geom[0][g], geom[1][g],
        jnp.asarray(p), np.repeat(geom[2][:1], 2, 0),
        np.repeat(geom[3][:1], 2, 0), jax_acoustic(GRID, CFG))
    assert rel_max(enc, jenc) <= 1e-5


@pytest.mark.parametrize("misfit,offset", [("l2", False), ("l1", True),
                                           ("l1", False)])
def test_encoded_gradient_matches_jax_on_its_encoding(misfit, offset):
    """The JAX encoding injected.  ``l1`` with an offset on the observed
    gathers keeps every residual's sign (3 shots a group, so no group's
    polarities sum to 0); on the real ``l1`` misfit the residuals before
    the first arrivals are rounding noise, whose signs set a few percent
    of the gradient in float32 in both packages, so both are held to the
    float64 gradient instead."""
    geom, vp = _case(6)
    vpt = vp.copy()
    vpt[10:20, 10:30] -= 100.0
    jcfg = jax_acoustic(GRID, CFG)
    jwav = jnp.asarray(ricker(10.0, GRID["nt"], GRID["dt"]).numpy())
    jgeom = tuple(jnp.asarray(a) for a in geom)
    obs = np.asarray(j_sim(jnp.asarray(vpt), jwav, *jgeom, jcfg))
    if offset:
        obs = obs + 10.0 * np.abs(obs).max()
    key = jax.random.PRNGKey(3)
    jl, jg = j_enc.encoded_fwi_gradient(jnp.asarray(vp), jnp.asarray(obs),
                                        jwav, *jgeom, jcfg, key, 2,
                                        misfit=misfit)
    groups, pol = j_enc.encode_shots(6, key, 2)
    tgeom = tuple(torch.as_tensor(a) for a in geom)
    tcfg = torch_acoustic(GRID, CFG)
    pl, pg = encoding.encoded_fwi_gradient(
        t(vp), t(obs), t(jwav), *tgeom, tcfg, 2, groups=t(groups),
        pol=t(pol), misfit=misfit)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    if misfit == "l2" or offset:
        assert rel_max(pg, jg) <= 1e-4
    else:
        _, dg = encoding.encoded_fwi_gradient(
            t(vp).double(), t(obs).double(), t(jwav).double(), *tgeom, tcfg,
            2, groups=t(groups), pol=t(pol), misfit=misfit)
        assert rel_l2(jg, dg) <= 5e-2 and rel_l2(pg, dg) <= 5e-2
    # a draw of the port's own from a generator, same shapes
    _, g2 = encoding.encoded_fwi_gradient(
        t(vp), t(obs), t(jwav), *tgeom, tcfg, 2,
        generator=torch.Generator().manual_seed(0), misfit=misfit)
    assert g2.shape == pg.shape and bool(torch.isfinite(g2).all())


SMALL_AC = dict(nz=40, nx=48, nt=400, dt=0.001, num_shots=4,
                num_receivers=24, filters=(4, 8, 16), chunk=25,
                water_rows=6, pml_width=12)


@pytest.fixture(scope="module")
def jwl():
    return JWorkload.build(nz=40, nx=48, nt=400, dt=0.001, num_shots=4,
                           num_receivers=24, chunk=25, water_rows=6,
                           pml_width=12, seed=0)


def _jax_encoding(je):
    """The encoding the JAX engine's next step draws: its step key, then
    the encoding key, split from its rng."""
    rng, _ = jax.random.split(je._rng)
    _, ek = jax.random.split(rng)
    return j_enc.encode_shots(int(je.wl.geom[0].shape[0]), ek,
                              je.cfg.encoded_shots)


def test_encoded_engine_two_steps_match_jax(jwl, tmp_path):
    kw = dict(SMALL_AC, save_dir=str(tmp_path), encoded_shots=2,
              validate_on_twin=False, freq_stages=(6.0,))
    jcfg = j_config.get_workload("marmousi_acoustic_encoded", **kw)
    cfg = config.get_workload("marmousi_acoustic_encoded", **kw)
    je = JEngine(jcfg, workload=dataclasses.replace(jwl))
    pe = AcousticDIPEngine(cfg, workload=port_workload(jwl), device="cpu")
    assert pe.physics_path == je.physics_path == "encoded"
    assert not pe._use_fused and pe._direct is None
    pe.net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, je.params)))
    # the stage data: the raw obs low-passed once per stage
    jpd, ppd = je._stage_phys_pd(6.0), pe._stage_data(6.0)
    assert rel_max(ppd["obs"], jpd["obs"]) <= 1e-5
    assert rel_max(ppd["obs_norm"], jpd["obs_norm"]) <= 1e-5
    assert pe._stage_data(0.0)["obs"] is pe.wl.obs
    for ep in (1, 2):
        groups, pol = _jax_encoding(je)
        pe.encoding = lambda g=t(groups), p=t(pol): (g, p)
        jrec = je.optimize_parameters(ep, freq=6.0)
        prec = pe.optimize_parameters(ep, freq=6.0)
        assert jrec.keys() == prec.keys() == {"loss_D", "loss_M_MSE", "lr"}
        for k in jrec:
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5,
                                       err_msg=f"epoch {ep} {k}")
    # the engine's own draws: a new encoding every step
    e1, e2 = AcousticDIPEngine.encoding(pe), AcousticDIPEngine.encoding(pe)
    assert e1[0].shape == (2, 2) and not (torch.equal(e1[0], e2[0])
                                          and torch.equal(e1[1], e2[1]))


def test_encoded_engine_refuses_per_shot_receivers(jwl, tmp_path):
    cfg = config.get_workload("marmousi_acoustic_encoded", **SMALL_AC,
                              save_dir=str(tmp_path), encoded_shots=2,
                              validate_on_twin=False)
    wl = port_workload(jwl)
    rcv_x = wl.acq.rcv_x.copy()
    rcv_x[1] = rcv_x[1][::-1]
    wl.acq = dataclasses.replace(wl.acq, rcv_x=rcv_x)
    with pytest.raises(ValueError, match="identical receiver spread"):
        AcousticDIPEngine(cfg, workload=wl, device="cpu")
