"""The ``seam_elastic`` family's gradient conditioning on the port against
the JAX package: ``smooth_spatial``, DENISE's EPRECOND weight
(``_illum_weight``, ``grad_illum_eps``) and ``grad_smooth`` in the
elastic engine's processed gradient and in an Adam step, on SEAM's
acquisition rows (sources on row 6, receivers on row 23, a free
surface) at a small size.

The JAX engine runs its fused path in interpret mode
(``extras={"fused_interpret": True}``) on the same numpy workload, with
the same generator weights loaded into the port; both train on every
shot (``shots_per_iter=None``).  The engines are built once, in a
module-scoped fixture, and switch between the conditionings by their
``cfg`` (both read it at each step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticElasticWorkload as JWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import ElasticDIPEngine as JEngine
from physicsbasedfwi2_tpu.ops.gradproc import smooth_spatial as j_smooth
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine.engines import ElasticDIPEngine
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax
from physicsbasedfwi2_tpu_torch.ops.gradproc import smooth_spatial, taper_top

from torch_parity import n, port_elastic_workload, rel_l2, rel_max, t

torch.set_num_threads(1)

ROWS = dict(src_depth_row=6, rcv_depth_row=23)  # SEAM's rows
WL = dict(nz=36, nx=48, dx=15.0, nt=64, dt=0.0015, pml_width=8,
          freq=20.0, num_shots=2, num_receivers=10, seed=0, water_rows=4,
          chunk=16)
CFG = dict(WL, filters=(4, 8, 16), shots_per_iter=None, lstart=0,
           grad_taper_rows=5, freq_stages=(15.0,))
# the conditionings compared: EPRECOND (which replaces the depth^2 ramp),
# smoothing alone (after the depth^2 ramp), and both
CONDITIONS = {"eprecond": dict(grad_illum_eps=0.05),
              "smooth": dict(grad_smooth=2),
              "eprecond+smooth": dict(grad_illum_eps=0.05, grad_smooth=2)}


@pytest.mark.parametrize("iters,case", [(1, "random"), (3, "random"),
                                        (3, "edges")])
def test_smooth_spatial_matches_jax(iters, case):
    rng = np.random.default_rng(iters)
    g = rng.standard_normal((23, 31)).astype(np.float32)
    if case == "edges":
        # spikes on the corners and the borders: edge replication decides
        # what the binomial passes give there
        g = np.zeros((23, 31), np.float32)
        g[0, 0], g[-1, -1], g[0, 15], g[11, -1] = 1.0, -2.0, 3.0, 0.5
    got = n(smooth_spatial(t(g), iters))
    ref = np.asarray(j_smooth(jnp.asarray(g), iters))
    assert rel_max(got, ref) <= 1e-6
    border = np.ones_like(ref, bool)
    border[1:-1, 1:-1] = False
    assert rel_max(got[border], ref[border]) <= 1e-6
    # a constant field stays exactly constant
    assert torch.equal(smooth_spatial(torch.full((5, 7), 2.5), iters),
                       torch.full((5, 7), 2.5))


def _phys_grad(je, pe, jcfg, cfg):
    """The processed physics gradient of both engines at the JAX
    generator's initial model, on every shot, at the first stage."""
    m = je._sample_model(je.params)[0]
    fc = jcfg.freq_stages[0]
    phys = dict(je._stage_pack(fc),
                fw=jnp.asarray(je._field_weights(jcfg.lstart + 1),
                               jnp.float32),
                tw=jnp.float32(jcfg.tether_weight), lowf_m=je.lowf[0])
    if jcfg.grad_illum_eps > 0:
        phys["ilw"] = je._illum_weight()
    jl, jg = jax.value_and_grad(je._make_physics_loss())(
        m, jnp.arange(WL["num_shots"], dtype=jnp.int32), phys)
    tl, tg = pe.physics_value_and_grad(t(m), fc=fc)
    return float(jl), np.asarray(jg), float(tl), n(tg)


@pytest.fixture(scope="module")
def seam_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("seam_engines")
    jcfg = j_config.get_workload(
        "seam_elastic", **CFG, save_dir=str(root / "jax"),
        extras=dict(ROWS, fused_interpret=True))
    cfg = config.get_workload("seam_elastic", **CFG, extras=dict(ROWS),
                              save_dir=str(root / "torch"))
    jwl = JWorkload.build(**{k: v for k, v in WL.items() if k != "seed"},
                          seed=0, **ROWS)
    pwl = port_elastic_workload(jwl)
    je = JEngine(jcfg, workload=jwl)
    pe = ElasticDIPEngine(cfg, workload=pwl, device="cpu")
    pe.net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, je.params)))
    out = dict(je=je, pe=pe, grads={}, steps={}, ilw_before_step=pe._ilw)
    for ep, (name, kw) in enumerate(CONDITIONS.items(), start=1):
        je.cfg, pe.cfg = jcfg.replace(**kw), cfg.replace(**kw)
        out["grads"][name] = _phys_grad(je, pe, je.cfg, pe.cfg)
        # one Adam step of each engine from the same state (a new JAX
        # step for the new conditioning)
        je._step_cache.clear()
        jrec = dict(je.optimize_parameters(ep), **je.test()[0])
        prec = dict(pe.optimize_parameters(ep), **pe.test()[0])
        out["steps"][name] = (jrec, prec)
    return out


def test_seam_rows_and_path(seam_run):
    je, pe = seam_run["je"], seam_run["pe"]
    assert pe.physics_path == "fused-plain" and je.physics_path == "fused"
    assert pe.wl.acq.src_z.tolist() == [6, 6]
    assert np.all(pe.wl.acq.rcv_z == 23)
    assert pe.wl.grid.free_surface
    assert rel_max(pe.wl.obs_vx, je.wl.obs_vx) <= 1e-5
    assert rel_max(pe.wl.obs_vz, je.wl.obs_vz) <= 1e-5


def test_illum_weight_matches_jax(seam_run):
    je, pe = seam_run["je"], seam_run["pe"]
    # built at the first physics step, not with the engine
    assert seam_run["ilw_before_step"] is None
    ref = np.asarray(je._illum_weight())
    got = pe._illum_weight()
    assert got is pe._illum_weight()  # computed once
    assert got.shape == (WL["nz"], WL["nx"]) and got.device == pe.device
    assert rel_l2(got, ref) <= 1e-5
    # 1 / (il / max + eps): from 1 / (1 + eps) where the illumination
    # peaks up to 1 / eps where it is dark
    assert float(got.min()) == pytest.approx(1.0 / 1.05, rel=1e-6)
    assert float(got.max()) <= 1.0 / 0.05


@pytest.mark.parametrize("name", sorted(CONDITIONS))
def test_conditioned_gradient_matches_jax(seam_run, name):
    jl, jg, tl, tg = seam_run["grads"][name]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tg.shape == jg.shape == (WL["nz"], WL["nx"], 2)
    assert rel_l2(tg, jg) <= 1e-4
    assert np.abs(tg).max() > 0


def test_eprecond_replaces_the_depth_ramp(seam_run):
    """With EPRECOND the processed gradient is taper x weight x
    grad_scale: the depth^2 ramp of the recipe is not applied on top."""
    pe = seam_run["pe"]
    saved = pe.cfg
    pe.cfg = saved.replace(grad_illum_eps=0.05, grad_smooth=0,
                           tether_weight=0.0)
    try:
        assert pe.cfg.grad_depth_power == 2.0
        m = pe._sample_model()[0]
        pd = pe._phys(15.0, 1, 0, pe.lowf[0])
        _, raw = pe._fused_value_and_grad(m, pe._train_pool, pd)
        _, got = pe._processed_value_and_grad(m, pe._train_pool, pd)
    finally:
        pe.cfg = saved
    want = (taper_top(raw.permute(2, 0, 1), CFG["grad_taper_rows"])
            * pd["ilw"] * saved.grad_scale)
    assert rel_max(got.permute(2, 0, 1), want) <= 1e-6


@pytest.mark.parametrize("name", sorted(CONDITIONS))
def test_adam_step_matches_jax(seam_run, name):
    jrec, prec = seam_run["steps"][name]
    assert jrec.keys() == prec.keys() == {
        "loss_D_MSE", "loss_M_MSE", "lr", "loss_V_MSE"}
    for k in ("loss_D_MSE", "loss_M_MSE", "loss_V_MSE"):
        np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-4, err_msg=k)
    assert prec["loss_D_MSE"] > 0.0
