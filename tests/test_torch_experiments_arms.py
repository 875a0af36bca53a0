"""``adam_vs_lbfgs``'s elastic arms on the port against the JAX tool
(``benchmarks/adam_vs_lbfgs.py``) on the CPU, one arm a case.

Each arm runs through the JAX tool (its ``main`` with ``--only``, the
JAX engine's fused path in interpret mode, ``get_workload`` and
``create_engine`` patched in the test) and through the port's
``run_arm``, whose ``engine=`` hook takes a port engine loaded with the
JAX engine's initial generator weights, on one shrunk known-density
tree, its traces cut to 64 steps.  Both packages train on the whole
shot pool each step, so no draw differs (ROADMAP Queue C).  The JAX
engines compile for ~30 s (Adam) and ~55 s (L-BFGS) here, which is why
these cases live apart from ``tests/test_torch_experiments.py``.
"""

import importlib.util

import jax
import numpy as np
import pytest

import physicsbasedfwi2_tpu.engine as j_engine
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.experiments import adam_vs_lbfgs
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax

from test_torch_experiments import (
    EL, ROOT, _elastic_tree, _jit_flax, _json_lines, _shrunk,
)

BUDGET = 6  # shot-gradients: two Adam steps of 3 shots, one L-BFGS step


def _jax_tool():
    """The JAX tool imported from its file; its import points
    ``jax_compilation_cache_dir`` at the repository's ``.cache/jax``,
    and the previous setting is put back."""
    prev = jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_bench_adam_vs_lbfgs", ROOT / "benchmarks" / "adam_vs_lbfgs.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    return mod


@pytest.mark.parametrize("arm", ["elastic_adam", "elastic_lbfgs"])
def test_adam_vs_lbfgs_arm_matches_jax(arm, tmp_path, monkeypatch, capsys):
    """The arm's records through both tools at rtol 1e-4 (the elastic
    engines' own parity tests' tolerance): the Adam arm's two records,
    the L-BFGS arm's one iteration (its probes, the budget they are
    charged, its misfit), each arm's final and validation model MSE."""
    size = dict(EL, nt=64)
    tree = _elastic_tree(tmp_path / "kd", nt=64)
    jinit = []
    jcreate = j_engine.create_engine

    def jmake(cfg, **kw):
        eng = jcreate(cfg, **kw)
        jinit.append(jax.tree_util.tree_map(np.asarray, eng.params))
        return eng

    _jit_flax(monkeypatch)
    monkeypatch.setattr(j_engine, "create_engine", jmake)
    monkeypatch.setattr(j_engine, "get_workload", _shrunk(
        j_config.get_workload, size, fused_interpret=True))
    _jax_tool().main(["--budget", str(BUDGET), "--dataroot", tree,
                      "--only", arm])
    want = _json_lines(capsys.readouterr().out)
    assert [r.get("arm") for r in want[:-1]] == [arm]

    monkeypatch.setattr(adam_vs_lbfgs, "get_workload",
                        _shrunk(config.get_workload, size))
    (workload, cfg), = adam_vs_lbfgs.arm_configs(
        dataroot=tree, save_dir=str(tmp_path), only=arm)
    eng = adam_vs_lbfgs.create_engine(cfg, device="cpu")
    eng.net.load_state_dict(params_from_flax(jinit[0]))
    got = adam_vs_lbfgs.run_arm(workload, cfg, BUDGET, engine=eng)
    assert (adam_vs_lbfgs.summary([got], BUDGET)["summary"].keys()
            == want[-1]["summary"].keys())

    w = want[0]
    for k in ("arm", "workload", "optimizer", "misfit", "iterations",
              "budget_spent"):
        assert got[k] == w[k], k
    for k in ("final_misfit", "final_model_mse", "best_model_mse",
              "val_model_mse"):
        np.testing.assert_allclose(got[k], w[k], rtol=1e-4, err_msg=k)
    assert [c[0] for c in got["curve"]] == [c[0] for c in w["curve"]]
    np.testing.assert_allclose([c[1:] for c in got["curve"]],
                               [c[1:] for c in w["curve"]], rtol=1e-4)
    if cfg.optimizer == "adam":
        assert (got["iterations"], got["budget_spent"]) == (2, 6)
    else:
        # one iteration: 3 shots x the probes of its line search
        probes = eng.opt.state.info.num_linesearch_steps
        assert got["iterations"] == 1 and probes >= 2
        assert got["budget_spent"] == 3 * probes
        assert eng.opt.evaluations == 1 + probes
