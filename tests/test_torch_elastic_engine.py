"""The elastic slice end to end: the port's ElasticDIPEngine against the
JAX engine built with ``extras={"fused_interpret": True}`` (both on the
fused path), on the same numpy workload and the same generator weights;
the frequency-continuation stage loop; the CLI; the default device.

Both engines run every shot each epoch (``shots_per_iter=None``): the
port draws its shot order from a ``torch.Generator`` and the JAX engine
from ``jax.random``, and a full draw makes the misfit independent of
the order.  The JAX engine and its three epochs are built once, in a
module-scoped fixture (its interpret-mode physics steps dominate the
file's time).
"""

import dataclasses
import json
import os
import subprocess
import sys

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
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine import engines as t_engines
from physicsbasedfwi2_tpu_torch.engine.engines import (
    ElasticDIPEngine, create_engine, default_device,
)
from physicsbasedfwi2_tpu_torch.engine.train import train
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax
from physicsbasedfwi2_tpu_torch.optim import SGHMC, SGLD

from torch_parity import (
    n, one_rank_mesh, port_elastic_workload, rel_l2, rel_max, t,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WL = dict(nz=36, nx=48, dx=15.0, nt=64, dt=0.0015, pml_width=8,
          freq=20.0, num_shots=2, num_receivers=10, seed=0, water_rows=4,
          chunk=16)
CFG = dict(WL, filters=(4, 8, 16), shots_per_iter=None, lstart=1,
           grad_taper_rows=5, freq_stages=(15.0,))


@pytest.fixture(scope="module")
def el_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("el_engines")
    jcfg = j_config.get_workload(
        "marmousi_elastic", **CFG, save_dir=str(root / "jax"),
        extras={"fused_interpret": True})
    cfg = config.get_workload("marmousi_elastic", **CFG,
                              save_dir=str(root / "torch"))
    wl_kw = {k: v for k, v in WL.items() if k != "seed"}
    jwl = JWorkload.build(**wl_kw, seed=0)
    pwl = port_elastic_workload(jwl)
    je = JEngine(jcfg, workload=jwl)
    pe = ElasticDIPEngine(cfg, workload=pwl, device="cpu")
    pe.net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, je.params)))
    out = dict(je=je, pe=pe, jcfg=jcfg, cfg=cfg, jwl=jwl)

    # the processed physics gradient at the generator's initial model,
    # on every shot, at the first stage, with the first physics epoch's
    # field weights and tether
    m = je._sample_model(je.params)[0]
    fc = jcfg.freq_stages[0]
    phys = dict(je._stage_pack(fc),
                fw=jnp.asarray(je._field_weights(jcfg.lstart + 1),
                               jnp.float32),
                tw=jnp.float32(jcfg.tether_weight), lowf_m=je.lowf[0])
    jl, jg = jax.value_and_grad(je._make_physics_loss())(
        m, jnp.arange(2, dtype=jnp.int32), phys)
    tl, tg = pe.physics_value_and_grad(t(m), fc=fc)
    out["physics"] = (float(jl), np.asarray(jg), float(tl), n(tg))
    out["steps"] = []
    for ep in (1, 2, 3):
        jv, pv = je.test()[0], pe.test()[0]
        out["steps"].append((dict(je.optimize_parameters(ep), **jv),
                             dict(pe.optimize_parameters(ep), **pv)))
    return out


def test_engine_path_and_observed_data(el_run):
    je, pe = el_run["je"], el_run["pe"]
    assert pe.physics_path == "fused-plain" and je.physics_path == "fused"
    assert pe.n_fields == je.n_fields == 2
    # both regenerated obs with the ring operator: float32 rounding
    assert rel_max(pe.wl.obs_vx, je.wl.obs_vx) <= 1e-5
    assert rel_max(pe.wl.obs_vz, je.wl.obs_vz) <= 1e-5
    assert rel_max(pe.in_vx, je.in_vx) <= 1e-5
    assert torch.equal(pe.lowf, t(je.lowf))
    pp, jp = pe._stage_pack(15.0), je._stage_pack(15.0)
    for k in ("wav", "ovx", "orx", "orz"):
        assert rel_max(pp[k], jp[k]) <= 1e-5, k


def test_processed_physics_gradient_matches(el_run):
    jl, jg, tl, tg = el_run["physics"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tg.shape == jg.shape == (36, 48, 2)
    # tapered, depth^2-weighted, x grad_scale, plus the lowf tether
    assert rel_l2(tg, jg) <= 1e-4
    # rows 0-4 are tapered, and the tether's pull is 0 in the pinned
    # water rows (model = low-frequency model there)
    assert np.all(tg[:4] == 0.0) and np.abs(tg).max() > 0


def test_three_epochs_match(el_run):
    for ep, (jrec, prec) in enumerate(el_run["steps"], start=1):
        assert jrec.keys() == prec.keys() == {
            "loss_D_MSE", "loss_M_MSE", "lr", "loss_V_MSE"}
        for k in ("loss_D_MSE", "loss_M_MSE", "loss_V_MSE"):
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-4,
                                       err_msg=f"epoch {ep} {k}")
    # epoch 1 is the warmup: no physics
    assert el_run["steps"][0][1]["loss_D_MSE"] == 0.0
    assert el_run["steps"][2][1]["loss_D_MSE"] > 0.0


@pytest.mark.parametrize("anneal", [0, 2])
def test_stage_loop_advances_after_warmup(tmp_path, capsys, anneal):
    cfg = config.get_workload(
        "marmousi_elastic", **dict(CFG, lstart=2, freq_stages=(4.0, 0.0),
                                   stage_max_epochs=1,
                                   tether_anneal_plateaus=anneal,
                                   tether_decay=0.5),
        save_dir=str(tmp_path))
    _, hist = train(cfg, epochs=5, quiet=False, device="cpu")
    # no advance during the warmup; then one stage per epoch, capped at
    # the last, where each further plateau relaxes the tether a notch
    assert [r["freq_stage"] for r in hist] == [4.0, 4.0, 0.0, 0.0, 0.0]
    out = capsys.readouterr().out
    assert out.count("[freq-continuation] advancing to stage 0.0 Hz at "
                     "epoch 3") == 1
    assert out.count("[tether-anneal]") == anneal
    assert [r["loss_D_MSE"] == 0.0 for r in hist] == [True, True, False,
                                                       False, False]
    assert all(np.isfinite(v) for r in hist for v in r.values()
               if isinstance(v, float))


def test_train_cli_elastic_small_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "physicsbasedfwi2_tpu_torch.engine.train",
         "--workload", "marmousi_elastic", "--small", "--device", "cpu",
         "--epochs", "2", "--save-dir", str(tmp_path), "--set",
         "lstart=1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "elastic physics path: fused-plain" in proc.stdout
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["epoch"] == 2 and last["freq_stage"] == 4.0
    assert last["loss_D_MSE"] > 0.0
    assert (tmp_path / "marmousi_elastic" / "latest_net_G.npz").exists()


@pytest.mark.parametrize("name", ["marmousi_elastic_real",
                                  "marmousi_elastic_parity",
                                  "marmousi_elastic_rho",
                                  "marmousi_elastic_zp",
                                  "seam_elastic", "seam_elastic_seabed",
                                  "seam_elastic_robust", "mcdip_uq",
                                  "mcdip_uq_robust"])
def test_elastic_variants_train_on_cpu(tmp_path, name):
    """The untethered, the strict-parity (raw L2, per-field rescale), the
    density-inversion (rho, Zp) recipes, the SEAM family (sources on row
    6, receivers on row 23 or following the seabed; EPRECOND in the
    robust recipe) and MC dropout, at the CLI's small size."""
    cfg = config.get_workload(name, save_dir=str(tmp_path)).replace(
        nz=40, nx=48, nt=120, num_shots=3, num_receivers=16,
        filters=(4, 8, 16), water_rows=6, lstart=1)
    engine, hist = train(cfg, epochs=3, quiet=True, device="cpu")
    assert engine.n_fields == (3 if name.endswith(("rho", "zp")) else 2)
    # the seabed-following receivers are multi-row: the "fast" path
    assert engine.physics_path == ("fast" if name.endswith("seabed")
                                   else "fused-plain")
    assert (engine._ilw is not None) == (cfg.grad_illum_eps > 0)
    assert hist[0]["loss_D_MSE"] == 0.0
    assert all(r["loss_D_MSE"] > 0.0 for r in hist[1:])
    assert hist[-1]["freq_stage"] == cfg.freq_stages[0]
    assert all(np.isfinite(v) for r in hist for v in r.values()
               if isinstance(v, float))


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card.*device=\"cpu\""):
        default_device()
    cfg = config.get_workload("marmousi_elastic", **CFG)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train(cfg, epochs=1, quiet=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert default_device() == torch.device("cuda:0")


def test_train_cli_without_a_card_fails(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "physicsbasedfwi2_tpu_torch.engine.train",
         "--workload", "marmousi_elastic", "--small", "--epochs", "1",
         "--save-dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr


def test_unported_elastic_options_raise(el_run, tmp_path):
    pe, cfg = el_run["pe"], el_run["cfg"]
    wl = pe.wl
    # ported since: tnl2 and backend="xla" leave the fused path, and
    # optimizer="lbfgs" is the port's L-BFGS (each engine on a copy of the
    # workload: the fast path regenerates its observed data)
    for kw, path in ((dict(misfit="tnl2"), "fast"),
                     (dict(backend="xla"), "xla"),
                     (dict(optimizer="lbfgs"), "fused-plain")):
        e = ElasticDIPEngine(cfg.replace(**kw), workload=dataclasses.replace(
            wl), device="cpu")
        assert e.physics_path == path, kw
        assert isinstance(e.opt, t_engines._Lbfgs) == ("optimizer" in kw)
    # ported since: EPRECOND (its weight waits for the first physics
    # step), gradient smoothing and MC dropout (a dropout generator of
    # its own)
    for kw in (dict(grad_illum_eps=0.1), dict(grad_smooth=2),
               dict(netG="AutoElMarMCDIP22", dropout=0.1)):
        e = ElasticDIPEngine(cfg.replace(**kw), workload=dataclasses.replace(
            wl), device="cpu")
        assert e.physics_path == "fused-plain" and e._ilw is None, kw
        assert (e._drop_gen is not None) == ("dropout" in kw)
    # ported since: SG-MCMC (each sampler with its noise generator on the
    # engine's device)
    for kind, cls in (("sgld", SGLD), ("sghmc", SGHMC)):
        e = ElasticDIPEngine(cfg.replace(optimizer=kind),
                             workload=dataclasses.replace(wl), device="cpu")
        assert isinstance(e.opt, cls) and e.lr_policy is None
        assert e.opt.generator.device == e.device
    # ported since: a mesh (one rank here), B3 on the rank's shots
    with one_rank_mesh(tmp_path) as mesh:
        e = ElasticDIPEngine(cfg, workload=dataclasses.replace(wl),
                             mesh=mesh, device="cpu")
        assert e.physics_path == "fused+mesh"
        m = e._sample_model()
        for a, b in zip(e.physics_value_and_grad(m),
                        pe.physics_value_and_grad(m)):
            assert torch.equal(a, b)
    assert t_engines._ENGINES["elastic_dip"] is ElasticDIPEngine
    assert isinstance(create_engine(cfg, workload=wl, device="cpu"),
                      ElasticDIPEngine)
