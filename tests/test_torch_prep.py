"""Dataset preparation and training from a dataroot: the port's prep
trees against the JAX package's on the same operators, each engine built
from a dataroot against its JAX counterpart (the same tree, the same
workload arrays, the first step's loss on a path both packages share),
and the CLIs with ``--dataroot`` and ``--device cpu``.

The port's prep simulates with the operators its engines invert with on
every device (B1's and the ring forward's plain versions here); the JAX
prep does so on a TPU only and uses ``simulate_acoustic`` /
``simulate_elastic`` elsewhere.  So the JAX trees these tests compare
against are made by the JAX prep with its simulation replaced by JAX
``forward2(..., interpret=True)`` and JAX ``simulate_elastic_ring``
(a ``lax.scan``), the operators of its TPU path.  After tests/test_data.py
and tests/test_engine.py's dataroot cases.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import physicsbasedfwi2_tpu.ops as j_ops
from physicsbasedfwi2_tpu.data import prep as j_prep
from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticElasticWorkload as JElastic,
)
from physicsbasedfwi2_tpu.data.synthetic import (
    write_elastic_npy_tree as j_write_elastic,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import (
    AcousticDIPEngine as JAcousticEngine, ClassicFWIEngine as JClassic,
    ElasticDIPEngine as JElasticEngine, LatentInversionEngine as JLatent,
)
from physicsbasedfwi2_tpu.ops.pallas_elastic_fused import (
    simulate_elastic_ring as j_ring,
)
from physicsbasedfwi2_tpu.ops.pallas_scalar2 import forward2 as j_forward2
from physicsbasedfwi2_tpu_torch.data import marmousi, prep
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine.race import main as race_main
from physicsbasedfwi2_tpu_torch.engine import test as t_test
from physicsbasedfwi2_tpu_torch.engine import train as t_train
from physicsbasedfwi2_tpu_torch.engine.engines import (
    AcousticDIPEngine, ClassicFWIEngine, ElasticDIPEngine,
    LatentInversionEngine, create_engine,
)
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax

from torch_parity import n, rel_max

torch.set_num_threads(1)

# a 40 x 48 acoustic grid from the canonical Marmousi, 4 shots
AC = dict(nz=40, nx=48, dx=10.0, nt=400, dt=0.001, freq=10.0, num_shots=4,
          num_receivers=24, pml_width=12, chunk=25, water_rows=6)
# a 36 x 48 elastic grid, 3 shots
EL = dict(nz=36, nx=48, dx=15.0, nt=64, dt=0.0015, freq=20.0, num_shots=3,
          num_receivers=10, pml_width=8, chunk=16, water_rows=4)


def _flax_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _grid(nz, nx):
    vp = marmousi.canonical_marmousi_vp(188, 480)
    return prep.resample_grid(prep.normalize_velocity(vp), nz, nx)


def _ac_prep_kw():
    return {k: AC[k] for k in ("dx", "nt", "dt", "freq", "num_shots",
                               "num_receivers", "pml_width", "water_rows",
                               "chunk")}


def _el_prep_kw():
    return {k: EL[k] for k in ("dx", "nt", "dt", "freq", "num_shots",
                               "num_receivers", "pml_width", "water_rows",
                               "chunk")}


@pytest.fixture(scope="module")
def ac_trees(tmp_path_factory):
    """The acoustic tree of both packages from one grid: the port's
    through B1's plain version, the JAX prep's through forward2 in
    interpret mode."""
    root = tmp_path_factory.mktemp("ac_trees")
    vp = _grid(AC["nz"], AC["nx"])
    prep.prepare_acoustic_tree(vp, str(root / "port"), **_ac_prep_kw(),
                               device="cpu")

    def j_sim(m, wav, *args):
        return j_forward2(m, wav, *args, interpret=True)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ops, "simulate_acoustic", j_sim)
        j_prep.prepare_acoustic_tree(vp, str(root / "jax"), **_ac_prep_kw())
    return root


@pytest.fixture(scope="module")
def el_trees(tmp_path_factory):
    """The elastic tree of both packages from one grid, through the ring
    forward (the port's plain version; JAX's lax.scan)."""
    root = tmp_path_factory.mktemp("el_trees")
    vp = _grid(EL["nz"], EL["nx"])
    prep.prepare_elastic_tree(vp, str(root / "port"), **_el_prep_kw(),
                              rho_start="true", device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ops, "simulate_elastic", j_ring)
        j_prep.prepare_elastic_tree(vp, str(root / "jax"), **_el_prep_kw(),
                                    rho_start="true")
    return root


@pytest.mark.parametrize("phase", ["train", "test"])
def test_acoustic_tree_matches_jax_forward2(ac_trees, phase):
    for letter in "BC":
        np.testing.assert_array_equal(
            np.load(ac_trees / "port" / f"{phase}{letter}" / "0.npy"),
            np.load(ac_trees / "jax" / f"{phase}{letter}" / "0.npy"))
    a = np.load(ac_trees / "port" / f"{phase}A" / "0.npy")
    ref = np.load(ac_trees / "jax" / f"{phase}A" / "0.npy")
    assert a.shape == (AC["num_shots"], AC["nt"], AC["num_receivers"])
    # forward2 minus its direct wave over 400 steps: the reflections are a
    # small part of the direct arrival, float32 rounding 2e-5 of max
    assert rel_max(a, ref) <= 2e-5


def test_acoustic_test_twin_is_a_bumped_copy(ac_trees):
    train_b = np.load(ac_trees / "port" / "trainB" / "0.npy")
    test_b = np.load(ac_trees / "port" / "testB" / "0.npy")
    assert not np.array_equal(train_b, test_b)
    np.testing.assert_array_equal(test_b[:AC["water_rows"]],
                                  train_b[:AC["water_rows"]])
    assert test_b.max() <= train_b.max() and test_b.min() >= train_b.min()


def test_elastic_tree_matches_jax_ring_forward(el_trees):
    for letter in "BC":
        np.testing.assert_array_equal(
            np.load(el_trees / "port" / f"train{letter}" / "0.npy"),
            np.load(el_trees / "jax" / f"train{letter}" / "0.npy"))
    c = np.load(el_trees / "port" / "trainC" / "0.npy")
    b = np.load(el_trees / "port" / "trainB" / "0.npy")
    np.testing.assert_array_equal(b[2], c[2])  # rho_start="true"
    assert not np.array_equal(b[0], c[0])
    for letter in "AD":
        a = np.load(el_trees / "port" / f"train{letter}" / "0.npy")
        ref = np.load(el_trees / "jax" / f"train{letter}" / "0.npy")
        assert a.shape == (EL["num_shots"], EL["nt"], EL["num_receivers"])
        assert rel_max(a, ref) <= 1e-5


@pytest.mark.parametrize("extras", [
    dict(obs_scheme="reference", free_surface=False),
    dict(obs_scheme="reference", src_depth_row=2, rcv_depth_row=7,
         rcv_follow_seabed=True),
])
def test_elastic_reference_scheme_tree_matches_jax(tmp_path, extras):
    """obs_scheme="reference": the split-PML simulate_elastic in both
    packages, with the SEAM-style acquisition rows and the seabed-
    following receivers threaded through."""
    vp = _grid(EL["nz"], EL["nx"])
    kw = dict(_el_prep_kw(), smooth_iters=5, **extras)
    prep.prepare_elastic_tree(vp, str(tmp_path / "port"), **kw,
                              device="cpu")
    j_prep.prepare_elastic_tree(vp, str(tmp_path / "jax"), **kw)
    for letter in "ABCD":
        a = np.load(tmp_path / "port" / f"train{letter}" / "0.npy")
        ref = np.load(tmp_path / "jax" / f"train{letter}" / "0.npy")
        assert rel_max(a, ref) <= 1e-5, letter
    with pytest.raises(ValueError):
        prep.prepare_elastic_tree(vp, str(tmp_path / "bad"), **kw,
                                  rho_start="bogus", device="cpu")


def _ac_cfg(pkg, root, tree, **kw):
    fields = dict(AC, filters=(4, 8, 16), backend="xla")
    fields.update(kw)
    fields.pop("water_rows")
    return pkg.get_workload("marmousi_acoustic", **fields).replace(
        save_dir=str(root), dataroot=str(tree))


def test_acoustic_engine_from_dataroot_matches_jax(ac_trees, tmp_path):
    jcfg = _ac_cfg(j_config, tmp_path / "jax", ac_trees / "jax")
    cfg = _ac_cfg(config, tmp_path / "torch", ac_trees / "jax")
    je = JAcousticEngine(jcfg)
    pe = AcousticDIPEngine(cfg, device="cpu")
    assert pe.wl.from_disk and pe.physics_path == je.physics_path == "xla"
    for a, b in ((pe.wl.obs, je.wl.obs), (pe.wl.vp_true, je.wl.vp_true),
                 (pe.wl.vp_start, je.wl.vp_start),
                 (pe.val_wl.obs, je.val_wl.obs),
                 (pe.val_wl.vp_true, je.val_wl.vp_true)):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    # XLA flushes the normalised precursors' subnormals to zero
    assert rel_max(pe.wl.obs_norm, je.wl.obs_norm) <= 1e-6
    assert pe.val_wl.from_disk
    assert rel_max(pe._direct, je._direct) <= 1e-5
    pe.net.load_state_dict(params_from_flax(_flax_np(je.params)))
    jv, pv = je.test()[0], pe.test()[0]
    np.testing.assert_allclose(pv["loss_V_MSE"], jv["loss_V_MSE"],
                               rtol=1e-5)
    jrec, prec = je.optimize_parameters(1), pe.optimize_parameters(1)
    assert jrec.keys() == prec.keys()
    np.testing.assert_allclose(prec["loss_D"], jrec["loss_D"], rtol=1e-5)
    np.testing.assert_allclose(prec["loss_M_MSE"], jrec["loss_M_MSE"],
                               rtol=1e-5)


def test_acoustic_engine_without_testA_has_no_twin(ac_trees, tmp_path):
    import shutil
    tree = tmp_path / "train_only"
    for letter in "ABC":
        shutil.copytree(ac_trees / "port" / f"train{letter}",
                        tree / f"train{letter}")
    pe = AcousticDIPEngine(_ac_cfg(config, tmp_path, tree, backend="auto"),
                           device="cpu")
    assert pe.val_wl is None and pe.physics_path == "fused-plain"
    # the port's tree fits its fused path at the true model
    loss, _ = pe.physics_value_and_grad(pe.wl.vp_true)
    assert float(loss) <= 1e-6
    assert torch.equal(pe._val_true, pe.wl.vp_true)


def _el_cfg(pkg, workload, root, tree, **kw):
    fields = dict(EL, filters=(4, 8, 16), shots_per_iter=None, lstart=0,
                  grad_taper_rows=5, freq_stages=(15.0,), backend="xla")
    fields.update(kw, num_shots=5)  # the tree's 3 shots win
    return pkg.get_workload(workload, **fields).replace(
        save_dir=str(root), dataroot=str(tree))


def test_elastic_engine_from_dataroot_matches_jax(el_trees, tmp_path,
                                                  capsys):
    tree = el_trees / "jax"
    jcfg = _el_cfg(j_config, "marmousi_elastic", tmp_path / "jax", tree)
    cfg = _el_cfg(config, "marmousi_elastic", tmp_path / "torch", tree)
    je = JElasticEngine(jcfg)
    pe = ElasticDIPEngine(cfg, device="cpu")
    assert "workload has 3 shots" in capsys.readouterr().out
    assert pe.n_shots == je.n_shots == 3
    assert pe.physics_path == je.physics_path == "xla" and pe.wl.from_disk
    for k in ("vp", "vs", "rho"):
        np.testing.assert_array_equal(n(pe.wl.true[k]),
                                      np.asarray(je.wl.true[k]))
        np.testing.assert_array_equal(n(pe.wl.start[k]),
                                      np.asarray(je.wl.start[k]))
    np.testing.assert_array_equal(n(pe.wl.obs_vx), np.asarray(je.wl.obs_vx))
    np.testing.assert_array_equal(n(pe.wl.obs_vz), np.asarray(je.wl.obs_vz))
    for a, b in zip(pe.wl.geom, je.wl.geom):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    pe.net.load_state_dict(params_from_flax(_flax_np(je.params)))
    # every shot each step: the draws' orders differ, the misfit does not
    jrec, prec = je.optimize_parameters(1), pe.optimize_parameters(1)
    np.testing.assert_allclose(prec["loss_D_MSE"], jrec["loss_D_MSE"],
                               rtol=1e-5)
    np.testing.assert_allclose(prec["loss_M_MSE"], jrec["loss_M_MSE"],
                               rtol=1e-5)


def test_classic_elastic_engine_from_dataroot_matches_jax(el_trees,
                                                          tmp_path):
    tree = el_trees / "jax"
    jcfg = _el_cfg(j_config, "classic_fwi_elastic", tmp_path, tree)
    cfg = _el_cfg(config, "classic_fwi_elastic", tmp_path, tree)
    je, pe = JClassic(jcfg), ClassicFWIEngine(cfg, device="cpu")
    assert pe.wl.from_disk and pe.n_shots == 3 and pe.physics_path == "xla"
    for k in ("vp", "vs"):
        np.testing.assert_array_equal(n(pe.params[k]),
                                      np.asarray(je.params[k]))
    np.testing.assert_array_equal(n(pe.wl.obs_vx), np.asarray(je.wl.obs_vx))
    jrec, prec = je.optimize_parameters(1), pe.optimize_parameters(1)
    for k in ("loss_D_MSE", "loss_M_MSE"):
        np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def latent_tree(tmp_path_factory):
    """A Latent2 tree (trainA gathers, trainB velocity) of two samples."""
    root = tmp_path_factory.mktemp("latent")
    rng = np.random.default_rng(5)
    for i in range(2):
        (root / "trainA").mkdir(exist_ok=True)
        (root / "trainB").mkdir(exist_ok=True)
        np.save(root / "trainA" / f"{i}.npy", rng.standard_normal(
            (AC["num_shots"], AC["nt"], AC["num_receivers"])).astype(
                np.float32) * 1e-3)
        np.save(root / "trainB" / f"{i}.npy",
                _grid(AC["nz"], AC["nx"]) + 10.0 * i)
    return root


def test_latent_engine_from_dataroot_matches_jax(latent_tree, tmp_path):
    fields = dict(AC, filters=(4, 8, 16))
    fields.pop("water_rows")
    kw = dict(save_dir=str(tmp_path), dataroot=str(latent_tree),
              extras={"latent_sample": 1})
    jcfg = j_config.get_workload("latent_inversion", **fields).replace(**kw)
    cfg = config.get_workload("latent_inversion", **fields).replace(**kw)
    je, pe = JLatent(jcfg), LatentInversionEngine(cfg, device="cpu")
    assert pe.wl.from_disk
    np.testing.assert_array_equal(n(pe.wl.obs), np.asarray(je.wl.obs))
    np.testing.assert_array_equal(n(pe.wl.vp_true), np.asarray(je.wl.vp_true))
    raw = np.load(latent_tree / "trainA" / "1.npy")
    np.testing.assert_allclose(n(pe.wl.obs), raw * 10.0, rtol=1e-6)
    pe.net.load_state_dict(params_from_flax(_flax_np(je.decoder_params)))
    jrec, prec = je.optimize_parameters(1), pe.optimize_parameters(1)
    for k in ("loss_D_MSE", "loss_M_MSE"):
        np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5, err_msg=k)


def _small_fields(fields):
    return sum((["--set", f"{k}={v!r}"] for k, v in fields.items()), [])


def test_train_test_cli_with_dataroot(ac_trees, tmp_path, capsys):
    fields = dict(AC, filters=(4, 8, 16))
    fields.pop("water_rows")
    common = ["--workload", "marmousi_acoustic", "--name", "t_cli",
              "--save-dir", str(tmp_path), "--dataroot",
              str(ac_trees / "port"), "--device", "cpu"]
    t_train.main(common + ["--epochs", "2"] + _small_fields(fields))
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["epoch"] == 2 and np.isfinite(last["loss_D"])
    assert "loss_V_MSE" in last  # the tree's test twin validates
    t_test.main(common + ["--results-dir", str(tmp_path / "res")]
                + _small_fields(fields))
    out = tmp_path / "res" / "t_cli" / "epoch_latest"
    metrics = json.loads((out / "metrics.json").read_text())
    assert np.load(out / "model.npy").shape == (AC["nz"], AC["nx"])
    # fwi-test's engine validates on the tree's test twin as train did
    eng = create_engine(config.get_workload("marmousi_acoustic", **fields)
                        .replace(dataroot=str(ac_trees / "port"),
                                 save_dir=str(tmp_path), name="t_cli"),
                        device="cpu")
    eng.load_networks("latest")
    np.testing.assert_allclose(metrics["loss_V_MSE"],
                               eng.test()[0]["loss_V_MSE"], rtol=1e-6)


def test_race_cli_with_dataroot(el_trees, tmp_path, capsys):
    fields = dict(EL, filters=(4, 8, 16), grad_taper_rows=5,
                  holdout_shots=1, holdout_every=1, lstart=1,
                  freq_stages=(15.0,), shots_per_iter=None)
    race_main(["--workload", "marmousi_elastic_robust", "--dataroot",
                 str(el_trees / "port"), "--seeds", "0,1",
                 "--probe-epochs", "2", "--epochs", "3", "--save-dir",
                 str(tmp_path), "--device", "cpu"] + _small_fields(fields))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["winner_seed"] in (0, 1) and len(out["seeds"]) == 2
    assert (tmp_path / "race_marmousi_elastic_robust_race.json").exists()


def _write_su(path, data, dt_us):
    with open(path, "wb") as f:
        for tr in data:
            hdr = np.zeros(240, np.uint8)
            hdr[114:116] = np.frombuffer(np.array([data.shape[1]], "<u2")
                                         .tobytes(), np.uint8)
            hdr[116:118] = np.frombuffer(np.array([dt_us], "<u2").tobytes(),
                                         np.uint8)
            f.write(hdr.tobytes())
            f.write(tr.astype("<f4").tobytes())


def test_prep_cli_grid_and_su_obs(tmp_path, capsys):
    """prep's CLI, as fwi-prep's: a SEG-Y grid to the acoustic and the
    elastic trees on the CPU, then SU gathers ingested over the elastic
    tree's A/D letters; each tree equal to the library functions'."""
    segy = str(tmp_path / "g.segy")
    marmousi.write_segy_grid(segy, marmousi.canonical_marmousi_vp(94, 120),
                             fmt=1)
    prep.main(["--grid", segy, "--out", str(tmp_path / "ac"), "--physics",
               "acoustic", "--nz", "30", "--nx", "40", "--nt", "200",
               "--num-shots", "2", "--num-receivers", "10", "--water-rows",
               "6", "--device", "cpu"])
    vp = prep.resample_grid(prep.normalize_velocity(
        prep.read_velocity_grid(segy)), 30, 40)
    prep.prepare_acoustic_tree(vp, str(tmp_path / "ac_ref"), nt=200,
                               num_shots=2, num_receivers=10, water_rows=6,
                               device="cpu")
    for d in ("trainA", "trainB", "trainC", "testA", "testB", "testC"):
        np.testing.assert_array_equal(
            np.load(tmp_path / "ac" / d / "0.npy"),
            np.load(tmp_path / "ac_ref" / d / "0.npy"))
    prep.main(["--grid", segy, "--out", str(tmp_path / "el"), "--physics",
               "elastic", "--nz", "30", "--nx", "40", "--nt", "80",
               "--num-shots", "2", "--num-receivers", "8", "--water-rows",
               "6", "--rho-start", "true", "--device", "cpu"])
    el_vp = prep.resample_grid(prep.normalize_velocity(
        prep.read_velocity_grid(segy)), 30, 40)
    prep.prepare_elastic_tree(el_vp, str(tmp_path / "el_ref"), nt=80,
                              num_shots=2, num_receivers=8, water_rows=6,
                              rho_start="true", device="cpu")
    for letter in "ABCD":
        np.testing.assert_array_equal(
            np.load(tmp_path / "el" / f"train{letter}" / "0.npy"),
            np.load(tmp_path / "el_ref" / f"train{letter}" / "0.npy"))
    su = tmp_path / "su"
    su.mkdir()
    rng = np.random.default_rng(0)
    want = {}
    for comp in ("x", "y"):
        for k in (1, 2):
            want[comp, k] = rng.standard_normal((8, 80)).astype(np.float32)
            _write_su(su / f"seis_{comp}.su.shot{k}", want[comp, k], 1500)
    prep.main(["--su-obs", str(su), "--out", str(tmp_path / "el")])
    assert "ingested SU observed data (2, 80, 8)" in capsys.readouterr().out
    np.testing.assert_array_equal(
        np.load(tmp_path / "el" / "trainD" / "0.npy")[1], want["y", 2].T)
    with pytest.raises(SystemExit):
        prep.main(["--out", str(tmp_path / "none")])


def test_elastic_engine_trains_from_su_tree_without_trainB(tmp_path):
    """real_data's flow at a small size: gathers written as SU files,
    ingested with --su-obs beside a hand-written trainC (no trainB), and
    the engine's model reference is the start."""
    jwl = JElastic.build(**{k: EL[k] for k in (
        "nz", "nx", "dx", "nt", "dt", "freq", "num_shots", "num_receivers",
        "pml_width", "chunk", "water_rows")}, free_surface=False)
    j_write_elastic(str(tmp_path / "tree"), jwl)
    su = tmp_path / "su"
    su.mkdir()
    for comp, letter in (("x", "A"), ("y", "D")):
        gathers = np.load(tmp_path / "tree" / f"train{letter}" / "0.npy")
        for k, g in enumerate(gathers, 1):
            _write_su(su / f"seis_{comp}.su.shot{k}", g.T, 1500)
    rd = tmp_path / "rd"
    (rd / "trainC").mkdir(parents=True)
    np.save(rd / "trainC" / "0.npy",
            np.load(tmp_path / "tree" / "trainC" / "0.npy"))
    prep.main(["--su-obs", str(su), "--out", str(rd)])
    cfg = _el_cfg(config, "marmousi_elastic", tmp_path, rd,
                  backend="auto", free_surface=False, lstart=1)
    eng = create_engine(cfg, device="cpu")
    assert eng.physics_path == "fused-plain" and eng.n_shots == 3
    for k in ("vp", "vs", "rho"):
        assert torch.equal(eng.wl.true[k], eng.wl.start[k])
    np.testing.assert_array_equal(n(eng.wl.obs_vx), np.asarray(jwl.obs_vx))
    hist = [eng.optimize_parameters(ep) for ep in (1, 2)]
    assert all(np.isfinite(r["loss_D_MSE"]) for r in hist)


def test_engine_dataroot_is_ported_and_mesh_still_raises(ac_trees, tmp_path):
    cfg = _ac_cfg(config, tmp_path, ac_trees / "port")
    # a mesh is ported since; without a process group it raises
    from physicsbasedfwi2_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match="init_process_group"):
        AcousticDIPEngine(cfg, mesh=make_mesh(), device="cpu")
    wl = AcousticDIPEngine(cfg, device="cpu").wl
    eng = AcousticDIPEngine(cfg.replace(dataroot=None), device="cpu",
                            workload=dataclasses.replace(wl))
    assert eng.wl.from_disk
