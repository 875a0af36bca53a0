"""The robust elastic recipe (``marmousi_elastic_robust``) on the port
against the JAX engine: held-out shots and ``loss_H``, the step cap,
``phase_reset_opt``, the drift guard's revert, the ``selected``
checkpoint, the seed race and ``evaluate`` (``fwi-test``); and the
port's subpackage exports against the JAX package's.

The JAX engine runs its fused path in interpret mode
(``extras={"fused_interpret": True}``) on the same numpy workload, with
the same generator weights loaded into the port.  Both engines train on
the whole pool each epoch (``shots_per_iter=None``): the two packages
draw shots from different generators, and a full draw makes the misfit
independent of the order.  The JAX engine and its four epochs are built
once, in a module-scoped fixture.
"""

import importlib
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticElasticWorkload as JWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import ElasticDIPEngine as JEngine
from physicsbasedfwi2_tpu.engine.test import evaluate as j_evaluate
from physicsbasedfwi2_tpu_torch.data.synthetic import write_elastic_npy_tree
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine import test as t_test
from physicsbasedfwi2_tpu_torch.engine.engines import (
    ElasticDIPEngine, holdout_split,
)
from physicsbasedfwi2_tpu_torch.engine.race import race
from physicsbasedfwi2_tpu_torch.engine.train import _snapshot, train
from physicsbasedfwi2_tpu_torch.models.convert import (
    npz_from_state_dict, params_from_flax,
)

from torch_parity import n, port_elastic_workload

torch.set_num_threads(1)

WL = dict(nz=36, nx=48, dx=15.0, nt=64, dt=0.0015, pml_width=8,
          freq=20.0, num_shots=5, num_receivers=10, seed=0, water_rows=4,
          chunk=16)
# the cap (m/s RMS) is below the uncapped model move of these epochs
# (10-19 m/s), so it binds; two stages keep the first one capped
CAP = 5.0
CFG = dict(WL, filters=(4, 8, 16), shots_per_iter=None, lstart=1,
           grad_taper_rows=5, freq_stages=(15.0, 20.0), holdout_shots=3,
           holdout_every=1, tether_weight=0.0, phase_reset_opt=True,
           step_cap=CAP)
EPOCHS = 4


def _rms(a, b) -> float:
    return float(np.sqrt(np.mean((n(a) - n(b)) ** 2)))


def _pair(root, jwl, pwl, **kw):
    """A JAX engine (fused, interpret mode) and a port engine on the
    same workload, with the JAX engine's generator weights."""
    jcfg = j_config.get_workload(
        "marmousi_elastic_robust", **dict(CFG, **kw),
        save_dir=str(root / "jax"), extras={"fused_interpret": True})
    cfg = config.get_workload("marmousi_elastic_robust", **dict(CFG, **kw),
                              save_dir=str(root / "torch"))
    je = JEngine(jcfg, workload=jwl)
    pe = ElasticDIPEngine(cfg, workload=pwl, device="cpu")
    pe.net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, je.params)))
    return je, pe


@pytest.fixture(scope="module")
def robust_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("el_robust")
    wl_kw = {k: v for k, v in WL.items() if k != "seed"}
    jwl = JWorkload.build(**wl_kw, seed=0)
    pwl = port_elastic_workload(jwl)
    je, pe = _pair(root, jwl, pwl)
    out = dict(root=root, je=je, pe=pe, jwl=jwl, pwl=pwl,
               h0=(je.holdout_misfit(15.0), pe.holdout_misfit(15.0)))
    out["steps"] = []
    for ep in range(1, EPOCHS + 1):
        jm0, pm0 = je._sample_model(je.params)[0], pe._sample_model()[0]
        jv, pv = je.test()[0], pe.test()[0]
        jrec = dict(je.optimize_parameters(ep), **jv)
        prec = dict(pe.optimize_parameters(ep), **pv)
        jrec["move"] = _rms(je._sample_model(je.params)[0], jm0)
        prec["move"] = _rms(pe._sample_model()[0], pm0)
        cap = pe.last_step_cap if ep > CFG["lstart"] else None
        prec["scale"] = None if cap is None else float(cap["scale"])
        out["steps"].append((jrec, prec))
    return out


def test_holdout_split_matches_jax(robust_run):
    je, pe = robust_run["je"], robust_run["pe"]
    np.testing.assert_array_equal(n(pe._holdout_idx), [1, 2, 3])
    for got, want in ((pe._holdout_idx, je._holdout_idx),
                      (pe._train_pool, je._train_pool)):
        np.testing.assert_array_equal(n(got), np.asarray(want))
    # numpy rounds half to even: marmousi_elastic_robust's 35 shots
    hold, pool = holdout_split(35, 3)
    assert hold.tolist() == [8, 17, 26] and len(pool) == 32
    assert not set(hold.tolist()) & set(pool.tolist())
    assert holdout_split(5, 3)[0].tolist() == [1, 2, 3]
    assert holdout_split(2, 3)[0].tolist() == [0]  # round(0.5) == 0
    assert holdout_split(5, 0)[0] is None


@pytest.mark.parametrize("misfit", ["tnl1", "l2", "snl2"])
def test_holdout_misfit_matches_jax(robust_run, tmp_path, misfit):
    if misfit == "tnl1":
        jh, ph = robust_run["h0"]
    else:
        je, pe = _pair(tmp_path, robust_run["jwl"], robust_run["pwl"],
                       misfit=misfit)
        jh, ph = je.holdout_misfit(15.0), pe.holdout_misfit(15.0)
        if misfit == "snl2":
            assert pe._stage_data(15.0)[0].ndim == 2  # per-shot wavelet
    assert np.isfinite(ph) and ph > 0
    np.testing.assert_allclose(ph, jh, rtol=1e-4)


def test_four_epochs_match(robust_run):
    for ep, (jrec, prec) in enumerate(robust_run["steps"], start=1):
        keys = {"loss_D_MSE", "loss_M_MSE", "lr", "loss_V_MSE", "move"}
        if ep > CFG["lstart"]:
            keys.add("loss_H")
        assert keys <= jrec.keys() and keys <= prec.keys()
        for k in keys - {"lr"}:
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-4,
                                       err_msg=f"epoch {ep} {k}")
    scales = [p["scale"] for _, p in robust_run["steps"][1:]]
    moves = [p["move"] for _, p in robust_run["steps"][1:]]
    # the cap binds on some epoch, and no capped epoch moves past it by
    # more than the second round leaves (GroupNorm's nonlinearity)
    assert min(scales) < 1.0 and all(0.0 < s <= 1.0 for s in scales)
    assert all(mv <= 1.1 * CAP for mv in moves), moves


def test_optimizer_is_fresh_at_the_first_physics_step(robust_run,
                                                      monkeypatch):
    cfg = robust_run["pe"].cfg.replace(save_dir=str(robust_run["root"]))
    pe = ElasticDIPEngine(cfg, workload=robust_run["pwl"], device="cpu")
    seen = []
    step = torch.optim.Adam.step

    def spy(self, *args, **kw):
        seen.append((id(self), len(self.state)))
        return step(self, *args, **kw)

    monkeypatch.setattr(torch.optim.Adam, "step", spy)
    for ep in (1, 2, 3):
        pe.optimize_parameters(ep)
    # warmup on the first optimizer; a new one, its state empty, at the
    # first physics epoch, and kept after
    n_params = len(list(pe.net.parameters()))
    assert [k for _, k in seen] == [0, 0, n_params]
    assert seen[1][0] != seen[0][0] and seen[2][0] == seen[1][0]
    assert all(int(s["step"]) == 2 for s in pe.opt.state.values())


def _small(tmp_path, name, **kw):
    return config.get_workload(
        "marmousi_elastic", **dict(WL, filters=(4, 8, 16), lstart=1,
                                   grad_taper_rows=5, **kw),
        name=name, save_dir=str(tmp_path))


def test_holdout_early_stopping_selected(robust_run, tmp_path):
    cfg = _small(tmp_path, "t_holdout", freq_stages=(4.0, 8.0),
                 stage_max_epochs=3, plateau_history=2, holdout_shots=2,
                 holdout_every=2)
    eng, hist = train(cfg, epochs=10, quiet=True, device="cpu")
    hold, pool = n(eng._holdout_idx), n(eng._train_pool)
    assert hold.tolist() == [1, 3] and pool.tolist() == [0, 2, 4]
    hs = [r["loss_H"] for r in hist if "loss_H" in r]
    assert len(hs) >= 2 and all(np.isfinite(hs))
    assert [r["epoch"] for r in hist if "loss_H" in r] == [2, 4, 6, 8, 10]
    sel = [r["selected_epoch"] for r in hist if "selected_epoch" in r]
    assert sel and all(hist[e - 1]["freq_stage"] == 8.0 for e in sel)
    path = tmp_path / "t_holdout" / "selected_net_G.npz"
    assert path.exists()
    # the selected tag loads back into the port ...
    eng.load_networks("selected")
    assert eng._sample_model().shape == (1, WL["nz"], WL["nx"], 2)
    # ... and into the JAX engine, which decodes the model that the port
    # decodes from the same weights and inputs
    je, pe = robust_run["je"], robust_run["pe"]
    jdir = os.path.join(je.cfg.save_dir, je.cfg.name)
    os.makedirs(jdir, exist_ok=True)
    shutil.copy(path, os.path.join(jdir, "selected_net_G.npz"))
    je_params, pe_params = je.params, _snapshot(pe)
    try:
        je.load_networks("selected")
        pe.net.load_state_dict(eng.net.state_dict())
        m_j = np.asarray(je._sample_model(je.params)[0])
        m_p = n(pe._sample_model()[0])
    finally:
        je.params = je_params
        pe.net.load_state_dict(pe_params)
    assert np.max(np.abs(m_j - m_p)) <= 1e-3, np.max(np.abs(m_j - m_p))


def test_drift_guard_reverts(tmp_path, capsys):
    cfg = _small(tmp_path, "t_guard", freq_stages=(4.0,),
                 stage_max_epochs=100, tether_weight=0.0, holdout_shots=2,
                 holdout_every=1, guard_patience=2, guard_tol=1.05,
                 guard_lr_ramp=3)
    eng = ElasticDIPEngine(cfg, device="cpu")
    # the warmup snapshot 1.0; then improve, worse, worse (revert at
    # epoch 4), and recover
    seq = iter([1.0, 0.9, 1.2, 1.2, 0.85, 0.8, 0.79])
    eng.holdout_misfit = lambda fc=None: next(seq)
    eng2, hist = train(cfg, epochs=7, quiet=False, engine=eng)
    assert eng2 is eng
    reverts = [r["guard_revert"] for r in hist if "guard_revert" in r]
    assert reverts == [4], reverts
    assert eng._guard_ramp_from == 4
    assert all(np.isfinite(r["loss_D_MSE"]) for r in hist[1:])
    sel = [r["selected_epoch"] for r in hist if "selected_epoch" in r]
    assert sel and sel[-1] == 7, sel
    out = capsys.readouterr().out
    assert out.count("[drift-guard] loss_H 1.2000 > 1.05 x stage best "
                     "0.9000: reverted") == 1
    assert "[drift-guard] 1 revert(s) over 7 epochs" in out
    assert "[early-stop] selected checkpoint: epoch 7" in out


def test_revert_restores_a_snapshot_bit_for_bit(robust_run):
    cfg = robust_run["pe"].cfg.replace(save_dir=str(robust_run["root"]),
                                       guard_lr_ramp=4)
    pe = ElasticDIPEngine(cfg, workload=robust_run["pwl"], device="cpu")
    for ep in (1, 2):
        pe.optimize_parameters(ep)
    snap = _snapshot(pe)
    for ep in (3, 4):
        pe.optimize_parameters(ep)
    moved = _snapshot(pe)
    assert any(not torch.equal(snap[k], moved[k]) for k in snap)
    pe.guard_revert(snap, 4)
    now = pe.net.state_dict()
    assert all(torch.equal(now[k], snap[k]) for k in snap)
    assert len(pe.opt.state) == 0 and pe._guard_ramp_from == 4
    assert pe._tether_ref is None
    # the next step runs at lr / guard_lr_ramp (the post-revert ramp)
    # and moves the generator, not the snapshot
    pe.optimize_parameters(4)
    assert pe.opt.param_groups[0]["lr"] == pytest.approx(cfg.lr / 4)
    assert any(not torch.equal(pe.net.state_dict()[k], snap[k]) for k in snap)


def test_seed_race_selects_and_continues(tmp_path):
    cfg = _small(tmp_path, "t_race", freq_stages=(4.0, 8.0),
                 stage_max_epochs=3, plateau_history=2, holdout_shots=2,
                 holdout_every=2)
    wseed, summaries, eng, hist = race(
        cfg, seeds=(0, 1), probe_epochs=6, epochs=8, quiet=True,
        device="cpu")
    assert wseed in (0, 1) and [s["seed"] for s in summaries] == [0, 1]
    assert all(s["best_loss_H"] > 0 for s in summaries)
    assert wseed == min(summaries, key=lambda s: s["best_loss_H"])["seed"]
    assert isinstance(eng, ElasticDIPEngine)
    # the winner's history: probe then continuation
    assert [r["epoch"] for r in hist] == list(range(1, 9))
    assert (tmp_path / f"t_race_s{wseed}" / "selected_net_G.npz").exists()
    with pytest.raises(ValueError, match="holdout_shots"):
        race(cfg.replace(holdout_shots=0), seeds=(0,), probe_epochs=1,
             device="cpu")


def test_evaluate_matches_jax(robust_run, tmp_path):
    je, pe = robust_run["je"], robust_run["pe"]
    jcfg = je.cfg.replace(save_dir=str(tmp_path / "ck"), name="t_eval")
    cfg = pe.cfg.replace(save_dir=str(tmp_path / "ck"), name="t_eval")
    # the trained port weights, under the JAX package's keys
    os.makedirs(tmp_path / "ck" / "t_eval")
    np.savez(tmp_path / "ck" / "t_eval" / "latest_net_G.npz",
             **npz_from_state_dict(pe.net.state_dict(), pe.net))
    got = t_test.evaluate(cfg, epoch="latest",
                          results_dir=str(tmp_path / "torch"),
                          workload=robust_run["pwl"], device="cpu")
    want = j_evaluate(jcfg, epoch="latest",
                      results_dir=str(tmp_path / "jax"),
                      workload=robust_run["jwl"])
    assert got.keys() == want.keys() == {"loss_V_MSE"}
    np.testing.assert_allclose(got["loss_V_MSE"], want["loss_V_MSE"],
                               rtol=1e-5)
    # the trained weights, not a fresh engine's
    assert got["loss_V_MSE"] == pytest.approx(pe.test()[0]["loss_V_MSE"],
                                              rel=1e-6)
    out = tmp_path / "torch" / "t_eval" / "epoch_latest"
    m = np.load(out / "model.npy")
    m_j = np.load(tmp_path / "jax" / "t_eval" / "epoch_latest" / "model.npy")
    assert m.shape == m_j.shape == (WL["nz"], WL["nx"], 2)
    assert np.max(np.abs(m - m_j)) <= 1e-3
    with open(out / "metrics.json") as f:
        assert json.load(f) == got


def test_test_cli_on_cpu(tmp_path, capsys):
    t_test.main(["--workload", "marmousi_elastic_robust", "--small",
                 "--device", "cpu", "--epoch", "selected", "--save-dir",
                 str(tmp_path / "ck"), "--results-dir", str(tmp_path / "res")])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"loss_V_MSE"} and last["loss_V_MSE"] > 0
    out = tmp_path / "res" / "marmousi_elastic_robust" / "epoch_selected"
    assert np.load(out / "model.npy").shape == (48, 64, 2)
    assert json.loads((out / "metrics.json").read_text()) == last


def test_test_cli_unported_options_raise(tmp_path):
    cfg = _small(tmp_path, "t_unported")
    # realizations > 1 is ported: without dropout the ensemble's samples
    # are all the deterministic model, so its spread is 0
    got = t_test.evaluate(cfg, realizations=4, device="cpu",
                          results_dir=str(tmp_path / "res"))
    out = tmp_path / "res" / "t_unported" / "epoch_latest"
    assert set(got) == {"realizations", "mc_std_mean", "loss_V_MSE"}
    assert got["realizations"] == 4 and got["mc_std_mean"] == 0.0
    assert sorted(os.listdir(out)) == ["mc_mean.npy", "mc_std.npy",
                                       "metrics.json"]
    # --dataroot is ported since: the CLI evaluates the same checkpoint on
    # the engine's own workload written as an npy tree (the models stored
    # /100, so equal to float32 rounding)
    eng = ElasticDIPEngine(cfg, device="cpu")
    write_elastic_npy_tree(str(tmp_path / "tree"), eng.wl)
    fields = dict(WL, filters=(4, 8, 16), lstart=1, grad_taper_rows=5)
    t_test.main(["--workload", "marmousi_elastic", "--name", "t_unported",
                 "--save-dir", str(tmp_path), "--results-dir",
                 str(tmp_path / "res_disk"), "--dataroot",
                 str(tmp_path / "tree"), "--device", "cpu"]
                + [f"--set={k}={v!r}" for k, v in fields.items()])
    disk = json.loads((tmp_path / "res_disk" / "t_unported" / "epoch_latest"
                       / "metrics.json").read_text())
    np.testing.assert_allclose(disk["loss_V_MSE"], got["loss_V_MSE"],
                               rtol=1e-5)


# names of the JAX subpackages' __all__ whose modules are not ported yet
# (ROADMAP Queue A); the set shrinks as the queue lands
NOT_PORTED = {
    "ops": set(),
    "geo": set(),
    "optim": set(),
    "engine": set(),
    "models": {"ModelParamNet"},
    "data": set(),
    "utils": set(),
    "landscape": set(),
    "parallel": set(),
}


@pytest.mark.parametrize("sub", sorted(NOT_PORTED))
def test_subpackage_exports_match_jax(sub):
    ref = importlib.import_module(f"physicsbasedfwi2_tpu.{sub}")
    port = importlib.import_module(f"physicsbasedfwi2_tpu_torch.{sub}")
    missing = set(ref.__all__) - set(port.__all__)
    assert missing == NOT_PORTED[sub], sorted(missing ^ NOT_PORTED[sub])
    for name in port.__all__:
        assert getattr(port, name) is not None, name
