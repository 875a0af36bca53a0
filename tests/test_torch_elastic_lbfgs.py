"""The sixth slice end to end: ``marmousi_elastic_lbfgs`` (full-batch
L-BFGS with the zoom line search, the ``tnl2`` misfit on the 5-field
sponge path) on the port's ElasticDIPEngine against the JAX engine, on
the same numpy workload and generator weights; ``loss_H`` on the fast
path; the acoustic engine with ``optimizer="lbfgs"``; ``profile_dir``
in ``train`` and the CLI.

Both elastic engines take the "fast" path here (the JAX one because
``tnl2`` has no fused kernel), and both run every shot each epoch
(``shots_per_iter=None``), so the shot-draw difference between the two
packages does not enter.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticAcousticWorkload as JAcWorkload,
    SyntheticElasticWorkload as JWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import (
    AcousticDIPEngine as JAcEngine, ElasticDIPEngine as JEngine,
)
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine.engines import (
    AcousticDIPEngine, ElasticDIPEngine, _Lbfgs,
)
from physicsbasedfwi2_tpu_torch.engine.train import train
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax

from torch_parity import port_elastic_workload, port_workload, rel_max, t

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WL = dict(nz=36, nx=48, dx=15.0, nt=64, dt=0.0015, pml_width=8,
          freq=20.0, num_shots=2, num_receivers=10, water_rows=4, chunk=16)
CFG = dict(WL, filters=(4, 8, 16), lstart=3)
AC_SIZE = dict(nz=32, nx=40, dx=10.0, nt=400, dt=0.001, freq=15.0,
               num_shots=3, num_receivers=8)


def _flax_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _engines(root, name, **kw):
    """The JAX and the port engine of ``name`` on one workload, the port's
    generator holding the JAX one's initial weights."""
    jcfg = j_config.get_workload(name, **CFG, save_dir=str(root / "jax"),
                                 **kw)
    cfg = config.get_workload(name, **CFG, save_dir=str(root / "torch"),
                              **kw)
    jwl = JWorkload.build(**WL, seed=0)
    pwl = port_elastic_workload(jwl)
    je = JEngine(jcfg, workload=jwl)
    pe = ElasticDIPEngine(cfg, workload=pwl, device="cpu")
    pe.net.load_state_dict(params_from_flax(_flax_np(je.params)))
    return je, pe


@pytest.fixture(scope="module")
def lbfgs_run(tmp_path_factory):
    """marmousi_elastic_lbfgs on both engines: 3 warmup epochs, then 3
    physics epochs, with each epoch's value-and-gradient evaluations."""
    je, pe = _engines(tmp_path_factory.mktemp("el_lbfgs"),
                      "marmousi_elastic_lbfgs")
    out = dict(je=je, pe=pe, steps=[])
    for ep in range(1, 7):
        jrec = je.optimize_parameters(ep)
        jn = 1 + int(je.opt_state[-1].info.num_linesearch_steps)
        prec = pe.optimize_parameters(ep)
        out["steps"].append((jrec, prec, jn, pe.opt.evaluations))
    return out


def test_path_and_observed_data(lbfgs_run):
    je, pe = lbfgs_run["je"], lbfgs_run["pe"]
    assert je.physics_path == pe.physics_path == "fast"
    assert isinstance(pe.opt, _Lbfgs) and pe.lr_policy is None
    # both regenerated the obs with the sponge operator
    assert rel_max(pe.wl.obs_vx, je.wl.obs_vx) <= 1e-5
    assert rel_max(pe.wl.obs_vz, je.wl.obs_vz) <= 1e-5
    assert "orx" not in pe._stage_pack(pe.cfg.freq_stages[0])
    # the misfit at the true model (true density) is zero
    m = torch.stack([pe.wl.true[k] for k in ("vp", "vs")], -1)
    loss, grad = pe.physics_value_and_grad(m, rho=pe.wl.true["rho"])
    assert float(loss) <= 1e-9 and grad.shape == (36, 48, 2)


def test_six_epochs_match(lbfgs_run):
    for ep, (jrec, prec, jn, pn) in enumerate(lbfgs_run["steps"], start=1):
        assert jrec.keys() == prec.keys() == {"loss_D_MSE", "loss_M_MSE"}
        for k in ("loss_D_MSE", "loss_M_MSE"):
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-4,
                                       err_msg=f"epoch {ep} {k}")
        # the same line search: as many evaluations as the JAX engine's
        assert pn == jn, (ep, pn, jn)
    steps = lbfgs_run["steps"]
    assert [s[1]["loss_D_MSE"] == 0.0 for s in steps] == [True] * 3 + \
        [False] * 3
    # the physics epochs descend
    d = [s[1]["loss_D_MSE"] for s in steps[3:]]
    assert d[2] < d[0]


def test_loss_h_on_the_fast_path_matches(tmp_path):
    je, pe = _engines(tmp_path, "marmousi_elastic_lbfgs", holdout_shots=1)
    assert pe._holdout_idx.tolist() == [0] and pe.physics_path == "fast"
    fc = pe.cfg.freq_stages[0]
    h_port, h_jax = pe.holdout_misfit(fc), je.holdout_misfit(fc)
    assert h_port > 0
    np.testing.assert_allclose(h_port, h_jax, rtol=1e-4)


def test_xla_path_and_receiver_layouts(tmp_path):
    """``backend="xla"`` takes the split-PML path on both engines; tnl1
    with duplicate receiver columns, and multi-row receivers, leave the
    fused path."""
    je, pe = _engines(tmp_path, "marmousi_elastic_lbfgs", backend="xla")
    assert je.physics_path == pe.physics_path == "xla"
    # the xla path keeps the workload's (split-PML) observed data
    assert torch.equal(pe.wl.obs_vx, t(je.wl.obs_vx))
    loss, grad = pe.physics_value_and_grad(pe._sample_model(),
                                           fc=pe.cfg.freq_stages[0])
    assert float(loss) > 0 and bool(torch.isfinite(grad).all())
    cfg = config.get_workload("marmousi_elastic", **CFG, misfit="tnl1",
                              save_dir=str(tmp_path / "d"))
    wl = dataclasses.replace(pe.wl)
    wl.acq = dataclasses.replace(wl.acq, rcv_x=np.repeat(
        wl.acq.rcv_x[:, :5], 2, axis=1))
    assert ElasticDIPEngine(cfg, workload=wl,
                            device="cpu").physics_path == "fast"
    wl = dataclasses.replace(pe.wl)
    rz = wl.acq.rcv_z.copy()
    rz[:, 1::2] += 3
    wl.acq = dataclasses.replace(wl.acq, rcv_z=rz)
    assert ElasticDIPEngine(cfg, workload=wl,
                            device="cpu").physics_path == "fast"


def test_acoustic_lbfgs_matches_jax(tmp_path):
    """The acoustic engine's L-BFGS branch (its "xla" path on both, plain
    autodiff) for 3 epochs."""
    kw = dict(AC_SIZE, filters=(4, 8), optimizer="lbfgs", backend="xla")
    jcfg = j_config.get_workload("marmousi_acoustic", **kw,
                                 save_dir=str(tmp_path / "jax"))
    cfg = config.get_workload("marmousi_acoustic", **kw,
                              save_dir=str(tmp_path / "torch"))
    jwl = JAcWorkload.build(**AC_SIZE, seed=0, water_rows=1)
    # (copied before the JAX engine subtracts the direct wave in place)
    pwl = port_workload(jwl)
    je = JAcEngine(jcfg, workload=jwl)
    pe = AcousticDIPEngine(cfg, workload=pwl, device="cpu")
    pe.net.load_state_dict(params_from_flax(_flax_np(je.params)))
    assert isinstance(pe.opt, _Lbfgs)
    assert je.physics_path == pe.physics_path == "xla"
    for ep in (1, 2, 3):
        jrec, prec = je.optimize_parameters(ep), pe.optimize_parameters(ep)
        assert jrec.keys() == prec.keys() == {"loss_D", "loss_M_MSE"}
        for k in jrec:
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-4,
                                       err_msg=f"epoch {ep} {k}")
        assert pe.opt.evaluations == 1 + int(
            je.opt_state[-1].info.num_linesearch_steps)


def test_train_writes_a_profile_on_cpu(tmp_path, capsys):
    cfg = config.get_workload("marmousi_elastic_lbfgs", **dict(CFG, lstart=1),
                              save_dir=str(tmp_path / "ck"))
    _, hist = train(cfg, epochs=2, profile_dir=str(tmp_path / "prof"),
                    profile_epochs=1, device="cpu")
    path = tmp_path / "prof" / "marmousi_elastic_lbfgs.pt.trace.json"
    assert f"profiler trace written to {path}" in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::conv2d" for e in events)
    assert len(hist) == 2 and hist[1]["loss_D_MSE"] > 0


def test_train_cli_lbfgs_small_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "physicsbasedfwi2_tpu_torch.engine.train",
         "--workload", "marmousi_elastic_lbfgs", "--small", "--device",
         "cpu", "--epochs", "2", "--save-dir", str(tmp_path / "ck"),
         "--set", "lstart=1", "--set", "extras={'lbfgs_linesearch': 3}",
         "--profile-dir", str(tmp_path / "prof"), "--profile-epochs", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("elastic physics path: fast (fused unavailable: misfit=tnl2)"
            in proc.stdout)
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["epoch"] == 2 and last["loss_D_MSE"] > 0.0
    assert (tmp_path / "prof" / "marmousi_elastic_lbfgs.pt.trace.json"
            ).exists()
