"""Classic FWI and the impedance recipe: the port's ``ops/impedance.py``
against the JAX package's (forward and gradient), and the port's
``ClassicFWIEngine`` and ``ImpedanceDIPEngine`` against the JAX engines
on the same numpy workloads (and, for the impedance engine, the same
generator weights).

Classic FWI's elastic step draws its shots from a ``torch.Generator``,
the JAX engine's from a ``jax.random`` key; the test hands the port the
JAX engine's draw of each step.
"""

import dataclasses
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticAcousticWorkload as JAcWorkload,
    SyntheticElasticWorkload as JElWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import (
    ClassicFWIEngine as JClassic, ImpedanceDIPEngine as JImpedance,
)
from physicsbasedfwi2_tpu.ops import impedance as j_imp
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine.engines import (
    ClassicFWIEngine, ImpedanceDIPEngine, _Lbfgs, create_engine,
)
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax
from physicsbasedfwi2_tpu_torch.ops import impedance as imp

from torch_parity import port_elastic_workload, port_workload, rel_max, t

torch.set_num_threads(1)

# tests/test_engine.py's SMALL_AC and SMALL_EL
SMALL_AC = dict(nz=40, nx=48, nt=400, dt=0.001, num_shots=4,
                num_receivers=24, filters=(4, 8, 16), chunk=25,
                water_rows=6, pml_width=12)
SMALL_EL = dict(nz=36, nx=48, nt=160, dt=0.0015, num_shots=4,
                num_receivers=20, filters=(4, 8, 16), chunk=25,
                water_rows=4, shots_per_iter=2, pml_width=12, lstart=0)
BUILD = ("nz", "nx", "nt", "dt", "num_shots", "num_receivers", "chunk",
         "water_rows", "pml_width")


def _flax_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _cfgs(name, root, small, **over):
    kw = dict(small, save_dir=str(root), **over)
    return (j_config.get_workload(name, **kw).replace(name="jax"),
            config.get_workload(name, **kw).replace(name="torch"))


@pytest.mark.parametrize("n_wavelet", [100, 63])
@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_impedance_synthetic_and_gradient_match_jax(n_wavelet, kind):
    rng = np.random.default_rng(0)
    vp = (2000.0 + 800.0 * rng.random((2, 30, 20, 1))).astype(np.float32)
    vt = (2000.0 + 800.0 * rng.random((2, 30, 20, 1))).astype(np.float32)
    kw = dict(freq=20.0, n_wavelet=n_wavelet, dt=2e-3, axis=-2)
    j = j_imp.impedance_synthetic(jnp.asarray(vp), **kw)
    p = imp.impedance_synthetic(t(vp), **kw)
    assert p.shape == vp.shape
    assert rel_max(p, j) <= 1e-5
    # the last sample along the axis has zero reflectivity
    assert float(imp.reflectivity(t(vp))[:, :, -1].abs().max()) == 0.0
    jl, jg = jax.value_and_grad(lambda v: j_imp.impedance_misfit(
        v, jnp.asarray(vt), kind=kind, **kw))(jnp.asarray(vp))
    v = t(vp).requires_grad_(True)
    pl = imp.impedance_misfit(v, t(vt), kind=kind, **kw)
    (pg,) = torch.autograd.grad(pl, v)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5)
    assert rel_max(pg, jg) <= 1e-4


@pytest.fixture(scope="module")
def jwl_ac():
    return JAcWorkload.build(**{k: SMALL_AC[k] for k in BUILD}, seed=0)


def _classic_acoustic(jwl, root, **over):
    jcfg, cfg = _cfgs("classic_fwi_acoustic", root, SMALL_AC, lr=5.0,
                      **over)
    je = JClassic(jcfg, workload=dataclasses.replace(jwl))
    pe = ClassicFWIEngine(cfg, workload=port_workload(jwl), device="cpu")
    return je, pe


def test_classic_acoustic_three_adam_steps_match_jax(jwl_ac, tmp_path):
    je, pe = _classic_acoustic(jwl_ac, tmp_path)
    assert not pe.is_elastic and pe.physics_path == "xla"
    assert isinstance(pe.opt, torch.optim.Adam)
    for ep in (1, 2, 3):
        jrec, prec = je.optimize_parameters(ep), pe.optimize_parameters(ep)
        assert jrec.keys() == prec.keys() == {"loss_D_MSE", "loss_M_MSE",
                                              "lr"}
        for k in jrec:
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5,
                                       err_msg=f"epoch {ep} {k}")
        assert rel_max(pe.params["vp"], je.params["vp"]) <= 1e-4
    # clipped as the JAX engine clips
    vp = pe.params["vp"].detach()
    assert float(vp.min()) >= 1490.0 and float(vp.max()) <= 4700.0
    (jv, jm), (pv, pm) = je.test(), pe.test()
    np.testing.assert_allclose(pv["loss_V_MSE"], jv["loss_V_MSE"],
                               rtol=1e-5)
    assert pm.shape == jm.shape == (SMALL_AC["nz"], SMALL_AC["nx"])
    # the JAX engine's checkpoint (key ['vp']) loads into the port's
    je.save_networks("from_jax")
    os.makedirs(pe._dir(), exist_ok=True)
    shutil.copy(os.path.join(je._dir(), "from_jax_net_G.npz"),
                os.path.join(pe._dir(), "from_jax_net_G.npz"))
    pe.load_networks("from_jax")
    assert np.array_equal(pe.params["vp"].detach().numpy(),
                          np.asarray(je.params["vp"]))


def test_classic_acoustic_lbfgs_step_matches_jax(jwl_ac, tmp_path):
    """One L-BFGS step: the direction from the processed gradient, the
    line search's probes on the raw loss."""
    je, pe = _classic_acoustic(jwl_ac, tmp_path, optimizer="lbfgs")
    assert isinstance(pe.opt, _Lbfgs) and pe.lr_policy is None
    jrec, prec = je.optimize_parameters(1), pe.optimize_parameters(1)
    assert jrec.keys() == prec.keys() == {"loss_D_MSE", "loss_M_MSE"}
    for k in jrec:
        np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5, err_msg=k)
    info = je.opt_state[-1].info
    assert pe.opt.state.info.num_linesearch_steps == int(
        info.num_linesearch_steps)
    assert rel_max(pe.params["vp"], je.params["vp"]) <= 1e-4


@pytest.fixture(scope="module")
def jwl_el():
    return JElWorkload.build(
        **{k: SMALL_EL[k] for k in BUILD}, seed=0, free_surface=True)


def _jax_shots(je):
    """The shot subset the JAX engine's next elastic step draws."""
    _, sub = jax.random.split(je._rng)
    return np.array(jax.random.permutation(sub, je.n_shots)[: je._nsub])


def test_classic_elastic_steps_match_jax_on_fixed_shots(jwl_el, tmp_path):
    jcfg, cfg = _cfgs("classic_fwi_elastic", tmp_path, SMALL_EL, lr=10.0)
    je = JClassic(jcfg, workload=dataclasses.replace(jwl_el))
    pe = ClassicFWIEngine(cfg, workload=port_elastic_workload(jwl_el),
                          device="cpu")
    assert pe.is_elastic and pe.physics_path == "fast"
    # both regenerated the obs with the fast operator
    assert rel_max(pe.wl.obs_vx, je.wl.obs_vx) <= 1e-4
    vs0 = pe.params["vs"].detach().clone()
    for ep in (1, 2):
        idx = _jax_shots(je)
        pe._draw_shots = lambda i=idx: torch.as_tensor(i)
        jrec, prec = je.optimize_parameters(ep), pe.optimize_parameters(ep)
        for k in jrec:
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5,
                                       err_msg=f"epoch {ep} {k}")
        for k in ("vp", "vs"):
            assert rel_max(pe.params[k], je.params[k]) <= 1e-4, k
    assert float((pe.params["vs"] - vs0).abs().max()) > 0  # vs is live
    (jv, jm), (pv, pm) = je.test(), pe.test()
    assert pm.shape == jm.shape == (SMALL_EL["nz"], SMALL_EL["nx"], 2)
    np.testing.assert_allclose(pv["loss_V_MSE"], jv["loss_V_MSE"],
                               rtol=1e-5)
    # the port's own draw: shots_per_iter distinct shots a step
    pe2 = ClassicFWIEngine(cfg, workload=port_elastic_workload(jwl_el),
                           device="cpu")
    idx = pe2._draw_shots()
    assert len(set(idx.tolist())) == SMALL_EL["shots_per_iter"]


def _zero_bias(name: str) -> bool:
    """A conv bias in front of a one-channel GroupNorm group: a zero
    gradient, which both frameworks return as rounding noise and Adam
    turns into +-lr steps; the net's output does not depend on it."""
    return re.search(r"convs\.\d+\.bias$", name) is not None


def test_impedance_engine_two_steps_match_jax(tmp_path):
    size = dict(nz=40, nx=48, filters=(4, 8, 16), num_receivers=24,
                chunk=25, pml_width=12)
    jcfg, cfg = _cfgs("marmousi_impedance", tmp_path, size)
    jwl = JAcWorkload.build(nz=40, nx=48, nt=64, dt=0.001, num_shots=1,
                            num_receivers=24, pml_width=12, chunk=25,
                            freq=14.0, seed=0)
    je = JImpedance(jcfg, workload=dataclasses.replace(jwl))
    pe = ImpedanceDIPEngine(cfg, workload=port_workload(jwl), device="cpu")
    assert rel_max(pe.obs_stack, je.obs_stack) <= 1e-5
    pe.net.load_state_dict(params_from_flax(_flax_np(je.params)))
    for ep in (1, 2):
        jrec, prec = je.optimize_parameters(ep), pe.optimize_parameters(ep)
        assert jrec.keys() == prec.keys() == {"loss_D_MSE", "loss_M_MSE",
                                              "lr"}
        for k in jrec:
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5,
                                       err_msg=f"epoch {ep} {k}")
    jp = params_from_flax(_flax_np(je.params))
    keep = [k for k in jp if not _zero_bias(k)]
    pp = pe.net.state_dict()
    num = sum(float(((pp[k] - jp[k]) ** 2).sum()) for k in keep)
    den = sum(float((jp[k] ** 2).sum()) for k in keep)
    assert (num / den) ** 0.5 <= 1e-3
    (jv, jm), (pv, pm) = je.test(), pe.test()
    np.testing.assert_allclose(pv["loss_V_MSE"], jv["loss_V_MSE"],
                               rtol=1e-4)
    assert pm.shape == jm.shape == (40, 48)


def test_engines_build_from_create_engine(tmp_path):
    for name, cls in (("classic_fwi_acoustic", ClassicFWIEngine),
                      ("marmousi_impedance", ImpedanceDIPEngine)):
        cfg = config.get_workload(name, **SMALL_AC, save_dir=str(tmp_path))
        assert isinstance(create_engine(cfg, device="cpu"), cls)
