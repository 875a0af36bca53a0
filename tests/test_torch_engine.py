"""The whole slice: the port's AcousticDIPEngine and train() against the
JAX engine built with ``extras={"fused_interpret": True}``, on the same
numpy workload and the same generator weights.

The workload has a one-row water layer.  With a deeper water layer the
direct-wave-subtracted residual cancels to rounding noise before the
scattered arrivals, the L1 signs there follow rounding, and no two
float32 implementations agree on the gradient (a 1e-7 change of the
direct rows moves it by percent); one row keeps that window short.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticAcousticWorkload as JWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import (
    AcousticDIPEngine as JEngine, LrPolicy as JLrPolicy,
)
from physicsbasedfwi2_tpu.engine.train import (
    PlateauDetector as JPlateauDetector, train as j_train,
)
from physicsbasedfwi2_tpu.models import apply_velocity_output as j_avo
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine import engines as t_engines
from physicsbasedfwi2_tpu_torch.engine.engines import (
    AcousticDIPEngine, LrPolicy,
)
from physicsbasedfwi2_tpu_torch.engine.train import PlateauDetector, train
from physicsbasedfwi2_tpu_torch.models import apply_velocity_output
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax
from physicsbasedfwi2_tpu_torch.optim import SGHMC, SGLD

from torch_parity import n, one_rank_mesh, port_workload, rel_l2, rel_max, t

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(nz=32, nx=40, dx=10.0, nt=400, dt=0.001, freq=15.0,
            num_shots=3, num_receivers=8)


def _flax_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """Build both engines on one workload, then record setup, the
    processed physics gradient and three Adam steps of each."""
    root = tmp_path_factory.mktemp("engines")
    jcfg = j_config.get_workload(
        "marmousi_acoustic", **SIZE, filters=(4, 8),
        save_dir=str(root / "jax"), extras={"fused_interpret": True})
    cfg = config.get_workload("marmousi_acoustic", **SIZE, filters=(4, 8),
                              save_dir=str(root / "torch"))
    jwl = JWorkload.build(**SIZE, seed=0, water_rows=1)
    je = JEngine(jcfg, workload=jwl)
    pe = AcousticDIPEngine(cfg, workload=port_workload(jwl), device="cpu")
    pe.net.load_state_dict(params_from_flax(_flax_np(je.params)))
    out = dict(je=je, pe=pe, jcfg=jcfg, cfg=cfg, jwl=jwl)
    out["val"] = (je.test()[0], pe.test()[0])

    # processed dJ/dvp at the generator's initial model
    physics_loss, pd = je._make_physics_loss()
    vp = j_avo(je._apply_net(je.params).field, je.true_b,
               water_vel=jcfg.water_vel)[0, :, :, 0]
    jl, jg = jax.value_and_grad(physics_loss)(vp, pd)
    vpt = t(vp).requires_grad_()
    tl = pe.physics_loss(vpt)
    tl.backward()
    out["physics"] = (float(jl), np.asarray(jg), float(tl.detach()),
                      n(vpt.grad))

    out["steps"] = [(je.optimize_parameters(ep), pe.optimize_parameters(ep))
                    for ep in (1, 2, 3)]
    out["params"] = (params_from_flax(_flax_np(je.params)),
                     {k: v.detach().clone()
                      for k, v in pe.net.state_dict().items()})
    with torch.no_grad():
        field = pe.net(pe.shots_in)[0]
    out["vp_after"] = (
        np.asarray(j_avo(je._apply_net(je.params).field, je.true_b)),
        n(apply_velocity_output(field, pe.true_b)))
    return out


def test_engine_path_and_setup_rows(slice_run):
    je, pe = slice_run["je"], slice_run["pe"]
    assert pe.physics_path == "fused-plain" and je.physics_path == "fused"
    # forward2 over 400 steps: float32 rounding, 1e-5 of max
    assert rel_max(pe._dir_rows, je._dir_rows) <= 1e-5
    # obs = pred - direct cancels (the reflections are ~1/30 of the
    # direct wave), which scales the same rounding up: 2e-5 of max
    assert rel_max(pe.wl.obs, je.wl.obs) <= 2e-5
    assert rel_max(pe.shots_in, je.shots_in) <= 2e-5
    assert rel_max(pe._phys["obs_rows"], je._pack["phys"]["obs_rows"]) <= 2e-5


def test_validation_loss_matches(slice_run):
    (jv, pv) = slice_run["val"]
    assert jv.keys() == pv.keys() == {"loss_V_MSE"}
    # the twin's generator output through one forward pass of the net
    np.testing.assert_allclose(pv["loss_V_MSE"], jv["loss_V_MSE"],
                               rtol=1e-5)


def test_processed_physics_gradient_matches(slice_run):
    jl, jg, tl, tg = slice_run["physics"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tg.shape == jg.shape
    # depth^2-weighted, water-masked, x grad_scale: 1e-3 rel L2, since
    # the few residuals within rounding of zero may take either sign
    assert rel_l2(tg, jg) <= 1e-3
    assert np.all(tg[0] == 0.0)  # the water row is masked


def test_three_adam_steps_match(slice_run):
    for jrec, prec in slice_run["steps"]:
        assert jrec.keys() == prec.keys() == {"loss_D", "loss_M_MSE", "lr"}
        for k in jrec:
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5,
                                       err_msg=k)
    jp, pp = slice_run["params"]
    # Conv biases feeding a one-channel GroupNorm group have a zero
    # gradient: Adam normalizes the two frameworks' rounding noise there
    # into steps of +-lr, so they are left out (filters (4, 8) make every
    # ConvBlock group one channel wide); the net's output is independent
    # of them and is compared below.
    keep = [k for k in pp if not (".block.convs." in k
                                  and k.endswith(".bias"))]
    num = sum(float(((pp[k] - jp[k]) ** 2).sum()) for k in keep)
    den = sum(float((jp[k] ** 2).sum()) for k in keep)
    assert (num / den) ** 0.5 <= 1e-3
    jv, pv = slice_run["vp_after"]
    assert rel_max(pv, jv) <= 1e-3


def test_train_history_and_checkpoints_cross_packages(slice_run):
    je, pe = slice_run["je"], slice_run["pe"]
    _, jh = j_train(slice_run["jcfg"], epochs=2, engine=je, quiet=True)
    _, ph = train(slice_run["cfg"], epochs=2, engine=pe, quiet=True)
    assert [list(r) for r in ph] == [list(r) for r in jh]
    for r in ph:
        assert all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float))
    # a checkpoint written by either package loads in the other
    jp_train = params_from_flax(_flax_np(je.params))
    pp_train = {k: v.clone() for k, v in pe.net.state_dict().items()}
    shutil.copy(os.path.join(pe._dir(), "2_net_G.npz"),
                os.path.join(je._dir(), "from_torch_net_G.npz"))
    je.load_networks("from_torch")
    jp = params_from_flax(_flax_np(je.params))
    for k, v in pp_train.items():
        assert torch.equal(jp[k], v), k
    shutil.copy(os.path.join(je._dir(), "latest_net_G.npz"),
                os.path.join(pe._dir(), "from_jax_net_G.npz"))
    pe.load_networks("from_jax")
    for k, v in pe.net.state_dict().items():
        assert torch.equal(jp_train[k], v), k


def test_config_registry_equal_field_for_field():
    assert config.list_workloads() == j_config.list_workloads()
    for name in config.list_workloads():
        a = dataclasses.asdict(config.get_workload(name))
        b = dataclasses.asdict(j_config.get_workload(name))
        assert a == b, name
    assert ([f.name for f in dataclasses.fields(config.ExperimentConfig)]
            == [f.name for f in dataclasses.fields(
                j_config.ExperimentConfig)])
    pairs = ["lr=0.5", "freq_stages=(4.0,8.0)", "misfit=tnl1"]
    assert (config.parse_set_overrides(pairs)
            == j_config.parse_set_overrides(pairs))


@pytest.mark.parametrize("policy", ["linear", "step", "cosine", "plateau",
                                    "constant"])
def test_lr_policy_matches_jax(policy):
    cfg = config.ExperimentConfig(lr_policy=policy, n_epochs=5,
                                  n_epochs_decay=7)
    jcfg = j_config.ExperimentConfig(lr_policy=policy, n_epochs=5,
                                     n_epochs_decay=7)
    a, b = LrPolicy(cfg), JLrPolicy(jcfg)
    losses = [1.0, 0.5, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.7, 0.2, 0.3]
    for epoch, loss in enumerate(losses, start=1):
        # the JAX schedules run in float32
        np.testing.assert_allclose(a.lr_for_epoch(epoch),
                                   b.lr_for_epoch(epoch), rtol=1e-6)
        np.testing.assert_allclose(a.after_epoch(loss), b.after_epoch(loss),
                                   rtol=1e-6)


@pytest.mark.parametrize("mode,eps,cap", [("range", 0.05, 0),
                                          ("improve", 0.01, 0),
                                          ("range", 5e-10, 4)])
def test_plateau_detector_matches_jax(mode, eps, cap):
    a = PlateauDetector(3, eps, mode=mode, stage_max_epochs=cap)
    b = JPlateauDetector(3, eps, mode=mode, stage_max_epochs=cap)
    rng = np.random.default_rng(8)
    losses = np.concatenate([np.linspace(1.0, 0.5, 8),
                             0.5 + 0.001 * rng.standard_normal(12)])
    assert ([a.update(float(x)) for x in losses]
            == [b.update(float(x)) for x in losses])


def test_unported_options_raise(slice_run, tmp_path):
    wl = port_workload(slice_run["jwl"])
    cfg = slice_run["cfg"]
    # (misfit="l2" and backend="xla" take the ported "xla" path;
    # freq_stages and wavelet_from_data are ported; so are L-BFGS and
    # profile_dir since)
    engine = AcousticDIPEngine(cfg.replace(optimizer="lbfgs"), workload=wl,
                               device="cpu")
    assert engine.physics_path == "fused-plain"
    assert isinstance(engine.opt, t_engines._Lbfgs)
    assert engine.lr_policy is None
    # encoded_shots is ported since: the "encoded" path, never fused
    e = AcousticDIPEngine(cfg.replace(encoded_shots=2), workload=wl,
                          device="cpu")
    assert e.physics_path == "encoded" and not e._use_fused
    # ported since: a mesh (one rank here): B2 on the rank's shots, the
    # same bits as without one
    with one_rank_mesh(tmp_path) as mesh:
        e = AcousticDIPEngine(cfg, workload=wl, mesh=mesh, device="cpu")
        assert e.physics_path == "fused+mesh"
        vp = wl.vp_true * 0.97
        for a, b in zip(e.physics_value_and_grad(vp),
                        engine.physics_value_and_grad(vp)):
            assert torch.equal(a, b)
    # SG-MCMC is ported since: no lr policy, as in the JAX engine
    for kind, cls in (("sghmc", SGHMC), ("sgld", SGLD)):
        e = AcousticDIPEngine(cfg.replace(optimizer=kind), workload=wl,
                              device="cpu")
        assert isinstance(e.opt, cls) and e.lr_policy is None
    _, hist = train(cfg.replace(save_dir=str(tmp_path)), epochs=1,
                    engine=engine, quiet=True,
                    profile_dir=str(tmp_path / "prof"), profile_epochs=1)
    assert (tmp_path / "prof" / f"{cfg.name}.pt.trace.json").exists()
    assert engine.opt.evaluations >= 2 and hist[0]["loss_D"] > 0


@pytest.fixture(scope="module")
def stage_run(slice_run):
    """The 4 Hz continuation stage on both engines of ``slice_run``: the
    stage data, and one step's loss from the same generator weights."""
    je, pe = slice_run["je"], slice_run["pe"]
    jpd, ppd = je._stage_phys_pd(4.0), pe._stage_data(4.0)
    out = {"data": {k: (np.asarray(jpd[k]), n(ppd[k]))
                    for k in ("wav", "obs_norm", "obs_rows", "dir_rows")}}
    pe.net.load_state_dict(params_from_flax(_flax_np(je.params)))
    out["step"] = (je.optimize_parameters(1, freq=4.0),
                   pe.optimize_parameters(1, freq=4.0))
    out["cached"] = pe._stage_data(4.0) is ppd
    return out


def test_stage_data_matches_jax(stage_run, slice_run):
    d = stage_run["data"]
    # the same zero-phase FFT low-pass of the same float32 data
    assert rel_max(*d["wav"][::-1]) <= 1e-6
    # the direct rows carry forward2's rounding (1e-5 of max,
    # test_engine_path_and_setup_rows) through the filter; obs = pred -
    # direct carries the 2e-5 of its cancellation, which the 4 Hz
    # low-pass (the band keeps a fraction of each trace's peak) and the
    # trace normalization scale up to ~7e-5 of max
    assert rel_max(d["dir_rows"][1], d["dir_rows"][0]) <= 1e-5
    for k in ("obs_norm", "obs_rows"):
        assert d[k][1].shape == d[k][0].shape, k
        assert rel_max(d[k][1], d[k][0]) <= 1e-4, k
    # the stage really band-limits the wavelet (as tests/test_engine.py)
    w = d["wav"][1]
    spec = np.abs(np.fft.rfft(w))
    f = np.fft.rfftfreq(w.shape[-1], slice_run["cfg"].dt)
    assert spec[f > 8.0].max() < 0.05 * spec.max()
    pe = slice_run["pe"]
    assert stage_run["cached"] and pe._stage_data(0.0) is pe._phys


def test_stage_step_loss_matches_jax(stage_run):
    jrec, prec = stage_run["step"]
    assert jrec.keys() == prec.keys() == {"loss_D", "loss_M_MSE", "lr"}
    for k in jrec:
        np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5, err_msg=k)


def test_train_advances_stages_like_jax(slice_run, stage_run):
    """train() over freq_stages (4, 8, 0) with a 3-epoch stage cap, as
    tests/test_engine.py runs the JAX package's: both packages walk the
    same stages and every epoch's loss is finite."""
    kw = dict(freq_stages=(4.0, 8.0, 0.0), stage_max_epochs=3)
    _, jh = j_train(slice_run["jcfg"].replace(**kw), epochs=7,
                    engine=slice_run["je"], quiet=True)
    _, ph = train(slice_run["cfg"].replace(**kw), epochs=7,
                  engine=slice_run["pe"], quiet=True)
    stages = [r["freq_stage"] for r in ph]
    # the third epoch of a stage advances it, and its record names the
    # new stage
    assert stages == [r["freq_stage"] for r in jh] == [4.0, 4.0, 8.0, 8.0,
                                                       8.0, 0.0, 0.0]
    assert all(np.isfinite(r["loss_D"]) for r in ph)
    assert list(slice_run["pe"]._stage_cache) == [8.0]


def test_autowav_step_with_per_shot_wavelets_matches_jax(tmp_path):
    """marmousi_acoustic_wav (AutoWav, wavelet_from_data): the engine
    gives each shot its own wavelet [ns, nt]; one step's loss from the
    same weights matches the JAX engine's."""
    jcfg = j_config.get_workload(
        "marmousi_acoustic_wav", **SIZE, filters=(4, 8),
        save_dir=str(tmp_path / "jax"), extras={"fused_interpret": True})
    cfg = config.get_workload("marmousi_acoustic_wav", **SIZE, filters=(4, 8),
                              save_dir=str(tmp_path / "torch"))
    jwl = JWorkload.build(**SIZE, seed=0, water_rows=1)
    pwl = port_workload(jwl)
    assert pwl.wavelet.ndim == 1
    je = JEngine(jcfg, workload=jwl)
    pe = AcousticDIPEngine(cfg, workload=pwl, device="cpu")
    assert tuple(pe.wl.wavelet.shape) == tuple(je.wl.wavelet.shape) == (
        SIZE["num_shots"], SIZE["nt"])
    np.testing.assert_array_equal(n(pe.wl.wavelet), np.asarray(je.wl.wavelet))
    pe.net.load_state_dict(params_from_flax(_flax_np(je.params)))
    jrec, prec = je.optimize_parameters(1), pe.optimize_parameters(1)
    for k in jrec:
        np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5, err_msg=k)


def test_port_imports_no_jax():
    code = ("import sys, physicsbasedfwi2_tpu_torch, "
            "physicsbasedfwi2_tpu_torch.engine.train, "
            "physicsbasedfwi2_tpu_torch.experiments.make_realdata_su, "
            "physicsbasedfwi2_tpu_torch.experiments.misfit_linescan, "
            "physicsbasedfwi2_tpu_torch.experiments.adam_vs_lbfgs, "
            "physicsbasedfwi2_tpu_torch.experiments.run_latent_flagship; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'physicsbasedfwi2_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
