"""The experiment tools (``physicsbasedfwi2_tpu_torch/experiments/``) and
``models.ModelParamNet`` against the JAX package's ``benchmarks/`` tools
and Flax module, on the CPU at tiny shapes.

Each JAX tool is imported from its file and driven through its own
``main``; its ``get_workload`` is patched in the test to give the same
shrunk config as the port's, and nothing in the JAX tree changes.  The
port's tools run through their ``main`` with ``--device cpu`` (the
kernels' plain versions).  Where a tool builds an engine, the port's
engine takes the JAX engine's initial generator weights, and every
physics epoch trains on the whole shot pool, so that no draw differs
between the packages (ROADMAP Queue C, "Differences the port cannot
match").
"""

import functools
import importlib.util
import json
import os
import types
from pathlib import Path

import flax.linen
import jax
import numpy as np
import pytest
import torch

import physicsbasedfwi2_tpu.engine as j_engine
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.models import ModelParamNet as JModelParamNet
from physicsbasedfwi2_tpu_torch.data.marmousi import canonical_marmousi_vp
from physicsbasedfwi2_tpu_torch.data.prep import prepare_elastic_tree
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine.engines import ElasticDIPEngine
from physicsbasedfwi2_tpu_torch.experiments import (
    adam_vs_lbfgs, make_realdata_su, misfit_linescan, run_latent_flagship,
)
from physicsbasedfwi2_tpu_torch.models import ModelParamNet
from physicsbasedfwi2_tpu_torch.models.convert import (
    npz_from_state_dict, params_from_flax, params_to_flax,
    state_dict_from_npz,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the elastic workloads shrunk (marmousi_elastic's family)
EL = dict(nz=36, nx=48, dx=15.0, nt=120, dt=0.0015, pml_width=8, freq=20.0,
          num_shots=3, num_receivers=10, water_rows=4, chunk=16,
          filters=(4, 8, 16), shots_per_iter=None, lstart=1)
# real_data shrunk (its dx, dt, bounds and acquisition rows kept)
RD = dict(nz=36, nx=48, nt=400, num_shots=3, num_receivers=10)


@pytest.fixture(scope="module")
def jtool():
    """The JAX package's tools in ``benchmarks/``, each imported from its
    file.  An import that points ``jax_compilation_cache_dir`` at the
    repository's ``.cache/jax`` has the previous setting put back."""
    prev = jax.config.jax_compilation_cache_dir
    mods = {}
    try:
        for name in ("make_realdata_su", "misfit_linescan",
                     "adam_vs_lbfgs"):
            spec = importlib.util.spec_from_file_location(
                f"jax_bench_{name}", ROOT / "benchmarks" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    return mods


def _shrunk(get, size, **extra):
    """``get_workload`` with ``size`` over the caller's overrides, and
    ``extra`` added to the ``extras`` (the caller's, else the
    workload's)."""
    def get_workload(workload, **kw):
        merged = dict(kw, **size)
        if extra:
            merged["extras"] = {**kw.get("extras", get(workload).extras),
                                **extra}
        return get(workload, **merged)
    return get_workload


def _jit_flax(monkeypatch):
    """Run the JAX generators' ``init`` and ``apply`` under jit: the JAX
    engines call them eagerly, one XLA compile an op (~25 s for an
    init at the shrunk size), and under jit each call is one compile."""
    for name in ("init", "apply"):
        method = getattr(flax.linen.Module, name)
        monkeypatch.setattr(
            flax.linen.Module, name,
            lambda self, first, *args, _m=method, **kw: jax.jit(
                functools.partial(_m, self, **kw))(first, *args))


def _json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


# ---------------------------------------------------------------- models

def test_model_param_net_matches_jax(tmp_path):
    init = np.random.default_rng(0).uniform(
        1500, 4500, (12, 20, 3)).astype(np.float32)
    jnet = JModelParamNet(init_model=init)
    jparams = jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(0)))
    net = ModelParamNet(init)
    assert [k for k, _ in net.named_parameters()] == ["model"]
    np.testing.assert_array_equal(net().detach().numpy(),
                                  np.asarray(jnet.apply(jparams)))
    assert tuple(net().shape) == (1, 12, 20, 3)
    # weights moved in the port carry to the JAX module and back
    with torch.no_grad():
        net.model.add_(torch.linspace(-1, 1, init.size).reshape(init.shape))
    flax = params_to_flax(net.state_dict(), net)
    assert list(flax["params"]) == ["model"]
    np.testing.assert_array_equal(np.asarray(jnet.apply(flax))[0],
                                  net.model.detach().numpy())
    back = ModelParamNet(init)
    back.load_state_dict(params_from_flax(flax))
    assert torch.equal(back.model, net.model)
    arrays = npz_from_state_dict(net.state_dict(), net)
    assert list(arrays) == ["['params']['model']"]
    np.savez(tmp_path / "m.npz", **arrays)
    with np.load(tmp_path / "m.npz") as z:
        sd = state_dict_from_npz({k: z[k] for k in z.files})
    assert torch.equal(sd["model"], net.model.detach())


# ------------------------------------------------------ make_realdata_su

def _su(path: Path, ns: int):
    """An SU file's headers [ntr, 240] (bytes) and traces [ntr, ns]."""
    raw = np.frombuffer(path.read_bytes(), np.uint8).reshape(-1, 240 + 4 * ns)
    return raw[:, :240], raw[:, 240:].copy().view("<f4")


def test_make_realdata_su_matches_jax(jtool, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(j_config, "get_workload",
                        _shrunk(j_config.get_workload, RD))
    monkeypatch.setattr(config, "get_workload",
                        _shrunk(config.get_workload, RD))
    jout, pout = tmp_path / "jax", tmp_path / "port"
    jtool["make_realdata_su"].main(["--out", str(jout)])
    make_realdata_su.main(["--out", str(pout), "--device", "cpu"])
    assert "ingested SU (3, 400, 10) dt=0.002s" in capsys.readouterr().out
    files = sorted(p.name for p in Path(f"{jout}_su").iterdir())
    assert files == sorted(p.name for p in Path(f"{pout}_su").iterdir())
    assert len(files) == 2 * RD["num_shots"]
    jtr = [_su(Path(f"{jout}_su") / f, RD["nt"]) for f in files]
    ptr = [_su(Path(f"{pout}_su") / f, RD["nt"]) for f in files]
    scale = max(np.abs(t).max() for _, t in jtr)
    for f, (jh, jt), (ph, pt) in zip(files, jtr, ptr):
        np.testing.assert_array_equal(ph, jh, err_msg=f)
        # split-PML in float32 in both packages: 1e-5 of the largest trace
        assert np.abs(pt - jt).max() <= 1e-5 * scale, f
    for rel in ("trainA/0.npy", "trainD/0.npy"):
        j, p = np.load(jout / rel), np.load(pout / rel)
        assert j.shape == p.shape == (3, 400, 10)
        assert np.abs(p - j).max() <= 1e-5 * np.abs(j).max(), rel
    for rel in ("trainC/0.npy", "trainB_oracle.npy"):
        np.testing.assert_allclose(np.load(pout / rel), np.load(jout / rel),
                                   rtol=1e-5, err_msg=rel)
    assert not (pout / "trainB").exists()
    # the clip the JAX tool keeps: water at 1500 m/s, below real_data's
    # clip_min of 3000 m/s
    vp = np.load(pout / "trainB_oracle.npy")[0] * 100.0
    assert vp.min() == pytest.approx(1500.0)


# ------------------------------------------------------- misfit_linescan

def _elastic_tree(root: Path, nt: int = EL["nt"]) -> str:
    """A known-density elastic tree at the shrunk size (the port's prep
    on the CPU), which both packages read."""
    prepare_elastic_tree(
        canonical_marmousi_vp(EL["nz"], EL["nx"]), str(root),
        dx=EL["dx"], nt=nt, dt=EL["dt"], freq=EL["freq"],
        num_shots=EL["num_shots"], num_receivers=EL["num_receivers"],
        pml_width=EL["pml_width"], water_rows=EL["water_rows"],
        chunk=EL["chunk"], rho_start="true", device="cpu")
    return str(root)


def test_misfit_linescan_matches_jax(jtool, tmp_path, monkeypatch, capsys):
    tree = _elastic_tree(tmp_path / "kd")
    # path D's checkpoint: a port engine's generator, saved with the JAX
    # package's npz keys
    run = tmp_path / "runs" / "drift"
    cfg = config.get_workload("marmousi_elastic", **EL, dataroot=tree,
                              name="drift", save_dir=str(run.parent))
    ElasticDIPEngine(cfg, device="cpu").save_networks("latest")

    jls = jtool["misfit_linescan"]
    _jit_flax(monkeypatch)
    monkeypatch.setattr(jls, "get_workload", _shrunk(
        j_config.get_workload, EL, fused_interpret=True))
    monkeypatch.setattr(misfit_linescan, "get_workload",
                        _shrunk(config.get_workload, EL))
    argv = ["--dataroot", tree, "--drift-run", str(run), "--alphas",
            "0,0.5,1"]
    jls.main(argv)
    want = _json_lines(capsys.readouterr().out)
    misfit_linescan.main(argv + ["--device", "cpu"])
    got = _json_lines(capsys.readouterr().out)
    assert len(got) == len(want) == 7
    np.testing.assert_allclose(
        [got[0]["drift_mse"], got[0]["lowf_mse"]],
        [want[0]["drift_mse"], want[0]["lowf_mse"]], rtol=1e-5)
    assert [(r["path"], r["a"]) for r in got[1:]] == [
        (p, a) for p in ("T(truth)", "D(drift)")
        for a in (0.0, 0.5, 1.0)]
    for key in ("mse", "l2", "snl2", "tnl1", "tnl2"):
        g = np.array([r[key] for r in got[1:]])
        w = np.array([r[key] for r in want[1:]])
        # rtol 1e-5, and where a value is at the rounding of the printed
        # records (8 decimals; 1 for mse) or ~0 at the truth, 1e-5 of
        # the scan's largest value of the key
        atol = max(1e-5 * np.abs(w).max(), 0.05 if key == "mse" else 5e-9)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol, err_msg=key)
    # the truth ranks below the starting model
    t_path = [r for r in got if r.get("path") == "T(truth)"]
    assert t_path[-1]["tnl2"] < t_path[0]["tnl2"]


# --------------------------------------------------------- adam_vs_lbfgs

class _StubEngine:
    """An engine stand-in that both packages' tools drive: fixed records
    a step (``loss_M`` alone in the acoustic engine's anchor warmup, as
    the acoustic DIP engine reports it), and an L-BFGS line search of
    ``1 + epoch % 3`` probes, in each package's state layout.  It holds
    the tools' own logic (warmup, budget, curve, summary) to each other
    exactly; the engines under them are held to the JAX engines by their
    own parity tests (tests/test_torch_elastic_robust.py,
    test_torch_elastic_lbfgs.py, test_torch_engine.py)."""

    def __init__(self, cfg, **kw):
        self.cfg = cfg
        self.n_shots = 7
        self.probes = 0

    @property
    def opt_state(self):  # optax's state: a leaf with the probe count
        return [types.SimpleNamespace(num_linesearch_steps=self.probes)]

    @property
    def opt(self):  # the port's: engines._Lbfgs
        return types.SimpleNamespace(state=types.SimpleNamespace(
            info=types.SimpleNamespace(num_linesearch_steps=self.probes)))

    def optimize_parameters(self, epoch):
        self.probes = 1 + epoch % 3
        acoustic = self.cfg.engine == "acoustic_dip"
        key = ("loss_M" if acoustic and epoch <= self.cfg.lstart
               else "loss_D" if acoustic else "loss_D_MSE")
        return {key: 1.0 / (epoch + 0.123456789),
                "loss_M_MSE": 5e4 / epoch + 0.0123}

    def test(self):
        return {"loss_V_MSE": 4.5e4 + self.probes}, None


def test_adam_vs_lbfgs_accounting_matches_jax(jtool, monkeypatch, capsys):
    """The same records from both tools over the same engine stand-in:
    every arm, with and without ``--acoustic`` and ``--only``, at a
    budget that takes Adam past the 60 points the curve keeps."""
    monkeypatch.setattr(j_engine, "create_engine", _StubEngine)
    monkeypatch.setattr(adam_vs_lbfgs, "create_engine", _StubEngine)
    for argv in (["--budget", "700"],
                 ["--budget", "700", "--acoustic", "--lbfgs-memory", "4"],
                 ["--budget", "50", "--acoustic", "--only", "acoustic"]):
        jtool["adam_vs_lbfgs"].main(argv)
        want = _json_lines(capsys.readouterr().out)
        adam_vs_lbfgs.main(argv + ["--device", "cpu"])
        assert _json_lines(capsys.readouterr().out) == want, argv
    assert [r["arm"] for r in want[:-1]] == ["acoustic_adam",
                                             "acoustic_lbfgs"]
    # Adam: shots_per_iter shots a step (marmousi_acoustic: None, all of
    # the stand-in's 7) after the free warmup; L-BFGS: the shots times
    # the probes of each line search
    adam, lbfgs = want[0], want[1]
    assert adam["budget_spent"] == 7 * adam["iterations"] >= 50
    first = config.get_workload("marmousi_acoustic").lstart + 1
    assert lbfgs["budget_spent"] == 7 * sum(
        1 + e % 3 for e in range(first, first + lbfgs["iterations"]))


def test_adam_vs_lbfgs_trains_every_arm(tmp_path, monkeypatch, capsys):
    """The tool on the port's engines at the shrunk size, both elastic
    arms (the acoustic pair's engines are held to the JAX engine's in
    test_torch_engine.py and test_torch_lbfgs.py): two Adam steps, one
    L-BFGS iteration charged its line search's probes, and the Adam
    arm's curve equal to its engine's own epochs."""
    # the traces cut to 64 steps: the L-BFGS line search's probes cost
    # most here
    shrunk = _shrunk(config.get_workload, dict(EL, nt=64))

    made = []

    def create(cfg, **kw):
        made.append(adam_vs_lbfgs_create(cfg, **kw))
        return made[-1]

    adam_vs_lbfgs_create = adam_vs_lbfgs.create_engine
    monkeypatch.setattr(adam_vs_lbfgs, "get_workload", shrunk)
    monkeypatch.setattr(adam_vs_lbfgs, "create_engine", create)
    png = tmp_path / "avl.png"
    adam_vs_lbfgs.main(["--budget", "6", "--png", str(png), "--device",
                        "cpu"])
    got = _json_lines(capsys.readouterr().out)
    assert png.stat().st_size > 0
    assert [r.get("arm") for r in got[:-1]] == ["elastic_adam",
                                                "elastic_lbfgs"]
    for r, eng in zip(got[:-1], made):
        assert np.isfinite([r["final_misfit"], r["final_model_mse"],
                            r["val_model_mse"]]).all(), r["arm"]
        if r["optimizer"] == "adam":
            assert (r["iterations"], r["budget_spent"]) == (2, 6), r["arm"]
        else:
            # one iteration: 3 shots x the probes of its line search
            probes = eng.opt.state.info.num_linesearch_steps
            assert r["iterations"] == 1 and probes >= 2, r["arm"]
            assert r["budget_spent"] == 3 * probes, r["arm"]
            assert eng.opt.evaluations == 1 + probes
    # the elastic Adam arm reports its engine's epochs: the same engine
    # built again and stepped by hand
    cfg = shrunk("marmousi_elastic", name="avl_elastic_adam",
                 save_dir=str(tmp_path))
    eng = adam_vs_lbfgs_create(cfg, device="cpu")
    eng.optimize_parameters(epoch=1)
    recs = [eng.optimize_parameters(epoch=e) for e in (2, 3)]
    assert got[0]["curve"] == [
        [3 * (i + 1), round(r["loss_D_MSE"], 6), round(r["loss_M_MSE"], 1)]
        for i, r in enumerate(recs)]


# --------------------------------------------------- run_latent_flagship

def test_run_latent_flagship_end_to_end(tmp_path, monkeypatch, capsys):
    small = dict(nz=36, nx=48, nt=200, dt=0.001, num_shots=3,
                 num_receivers=10, filters=(4, 8, 16))
    monkeypatch.setattr(run_latent_flagship, "get_workload",
                        _shrunk(config.get_workload, small))
    run_latent_flagship.main(["--epochs", "2", "--pretrain-epochs", "1",
                              "--bank", "2", "--name", "lat", "--save-dir",
                              str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "pretraining VAE on a 2-model bank (36x48)" in out
    assert "pretrain recon loss" in out
    run = tmp_path / "lat"
    lines = (run / "metrics.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    assert [r["epoch"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss_D_MSE"]) for r in recs)
    # the checkpoint holds the latent alone
    with np.load(run / "latest_net_G.npz") as z:
        assert z.files == ["['z']"]
        assert z["['z']"].shape == (1, config.get_workload(
            "latent_inversion").latent_dim)
    assert {"2_net_G.npz", "latest_net_G.npz"} <= set(os.listdir(run))
