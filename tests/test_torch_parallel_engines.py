"""The engines under a rank mesh: gloo ranks on the CPU (``dryrun.spawn``)
each build the engine with ``mesh=`` and take one step
(``tests/parallel_ranks.py``); the same engine without a mesh takes the
step here.  The engines without a mesh are held to the JAX engines by
their own tests; the acoustic ``fused+mesh`` and the elastic ``+mesh``
steps are also held to the JAX engine built with ``jpar.make_mesh(n)``
on as many of the 8 virtual CPU devices, on the same workload and
weights.

Every rank must end with the same bits.  Against the engine without a
mesh: the loss and the generator's gradient to 1e-5 (the shots' sums in
another order), and the updated weights to 1e-6 wherever the gradient
is above 1e-4 of its largest element, elsewhere to 2 lr.  Adam's first
step is lr times the gradient's sign, so an element whose gradient is
within the rounding of zero moves by +-lr either way.

The acoustic cases run without the direct wave: with it, the traces
that no scattered arrival reaches within nt are direct-removed rounding
noise, which the trace normalization scales to O(1) (ROADMAP Queue C),
and their share of the gradient then follows each shot's rounding.
"""

import jax
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu import parallel as jpar
from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticAcousticWorkload as JAcousticWorkload,
    SyntheticElasticWorkload as JElasticWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import (
    AcousticDIPEngine as JAcousticEngine, ElasticDIPEngine as JElasticEngine,
)
from physicsbasedfwi2_tpu_torch.device import default_device
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine.engines import (
    ElasticDIPEngine, MultiSampleAcousticDIPEngine, _engine_device,
    create_engine,
)
from physicsbasedfwi2_tpu_torch.parallel import Mesh, mesh as t_mesh
from parallel_ranks import engine_step, run_check
from physicsbasedfwi2_tpu_torch.parallel.dryrun import spawn
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax
from physicsbasedfwi2_tpu_torch.ops import cuda_build

from torch_parity import (
    one_rank_mesh, port_elastic_workload, port_workload, rel_l2,
)

torch.set_num_threads(1)

SMALL_AC = dict(nz=32, nx=48, nt=96, dt=0.001, num_shots=6,
                num_receivers=16, filters=(4, 8, 16), chunk=16, water_rows=4,
                pml_width=8, lstart=0, direct_wave=False)
SMALL_EL = dict(nz=32, nx=48, nt=120, dt=0.0015, num_shots=4,
                shots_per_iter=4, num_receivers=16, filters=(4, 8), chunk=20,
                water_rows=4, pml_width=10, lstart=0, freq=12.0,
                freq_stages=(), grad_taper_rows=4)


def _mesh_step(tmp_path, workload, overrides, world, mesh2d=None,
               payload=None) -> dict:
    """One step of the engine on ``world`` gloo ranks (with ``payload``,
    a (workload, state dict) pair, on that workload and those weights);
    rank 0's outputs, after holding every other rank's to the same
    bits."""
    d = tmp_path / "ranks"
    d.mkdir()
    inputs = dict(workload=np.array(workload),
                  overrides=np.array(repr(overrides)))
    if mesh2d is not None:
        inputs["mesh"] = np.array(repr(mesh2d))
    if payload is not None:
        torch.save(payload, d / "payload.pt")
        inputs["payload"] = np.array(str(d / "payload.pt"))
    np.savez(d / "in.npz", **inputs)
    spawn(run_check, world, "engine", str(d / "in.npz"), str(d), "cpu",
          device="cpu", store_dir=str(d))
    outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]
    for r, o in enumerate(outs[1:], 1):
        for k, v in o.items():
            np.testing.assert_array_equal(v, outs[0][k],
                                          err_msg=f"rank {r} {k}")
    return outs[0]


def _hold(got: dict, ref: dict, path: str, lr: float) -> None:
    assert str(got["physics_path"]) == path
    assert str(got["device"]) == "cpu"
    keys = [k for k in ref if k.startswith("rec")]
    assert keys and sorted(keys) == sorted(k for k in got
                                           if k.startswith("rec"))
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    g, w = ref["grads"].numpy(), ref["weights"].numpy()
    assert rel_l2(got["grads"], g) <= 1e-5
    sure = np.abs(g) > 1e-4 * np.abs(g).max()
    np.testing.assert_allclose(got["weights"][sure], w[sure], rtol=0,
                               atol=1e-6)
    assert np.abs(got["weights"] - w).max() <= 2 * lr + 1e-6


@pytest.mark.parametrize("world,over,path", [
    # 6 shots padded to 8: kernel B2's plain version per rank
    (4, {}, "fused+mesh"),
    # 6 shots padded to 9 with the mask: autograd through simulate_acoustic
    (3, {"backend": "xla", "misfit": "l2"}, "sharded-xla"),
])
def test_acoustic_engine_mesh_step_matches_unsharded(tmp_path, world, over,
                                                     path):
    ov = dict(SMALL_AC, save_dir=str(tmp_path), **over)
    got = _mesh_step(tmp_path, "marmousi_acoustic", ov, world)
    ref = create_engine(config.get_workload("marmousi_acoustic", **ov),
                        device="cpu")
    _hold(got, engine_step(ref), path, ref.cfg.lr)


@pytest.mark.parametrize("backend,misfit,base", [
    ("auto", "l2", "fused"),  # B3's plain version per rank
    ("fast", "l2", "fast"),   # autograd per rank, then a mean all-reduce
    ("fast", "tnl1", "fast"),
    ("xla", "l2", "xla"),
    ("xla", "tnl1", "xla"),
])
def test_elastic_engine_mesh_step_matches_unsharded(tmp_path, backend,
                                                    misfit, base):
    """4 shots a step over 2 ranks, rank 0's shot draw broadcast, on each
    of the elastic engine's paths."""
    ov = dict(SMALL_EL, save_dir=str(tmp_path), backend=backend,
              misfit=misfit)
    got = _mesh_step(tmp_path, "marmousi_elastic", ov, 2)
    ref = create_engine(config.get_workload("marmousi_elastic", **ov),
                        device="cpu")
    assert ref.physics_path == ("fused-plain" if base == "fused" else base)
    _hold(got, engine_step(ref), base + "+mesh", ref.cfg.lr)


def _flat_state(names, flat) -> dict:
    """``engine_step``'s flat weights, split back by parameter name."""
    return dict(zip([str(k) for k in names], flat))


def _hold_jax(got: dict, jrec: dict, jparams, keys: dict,
              rtol: float) -> None:
    """The ranks' first step against the JAX engine's: each record key to
    ``rtol``, and the updated weights to 1e-3 relative L2.  Conv biases
    feeding a one-channel GroupNorm group have a zero gradient, where
    Adam normalizes the two frameworks' rounding noise into steps of
    +-lr (tests/test_torch_engine.py), so they are left out."""
    for k, jk in keys.items():
        np.testing.assert_allclose(float(got[f"rec1_{k}"]), float(jrec[jk]),
                                   rtol=rtol, err_msg=k)
    jp = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    names = [str(k) for k in got["names"]]
    sizes = [jp[k].numel() for k in names]
    pp = dict(zip(names, np.split(got["weights"], np.cumsum(sizes)[:-1])))
    keep = [k for k in names if not (".block.convs." in k
                                     and k.endswith(".bias"))]
    num = sum(float(((pp[k] - jp[k].double().flatten().numpy()) ** 2).sum())
              for k in keep)
    den = sum(float((jp[k].double() ** 2).sum()) for k in keep)
    assert (num / den) ** 0.5 <= 1e-3


AC_JAX = dict(nz=32, nx=40, dx=10.0, nt=400, dt=0.001, freq=15.0,
              num_shots=6, num_receivers=8)


def test_acoustic_engine_mesh_step_matches_jax_mesh_engine(tmp_path):
    """6 shots padded to 8 over 4 ranks, B2's plain version per rank,
    against the JAX engine on ``jpar.make_mesh(4)`` (B2 in interpret
    mode): tests/test_torch_engine.py's workload (one water row, so that
    the residuals keep their signs) with 6 shots, the same weights, the
    loss to 1e-5 (the shots' sums in another order)."""
    jcfg = j_config.get_workload(
        "marmousi_acoustic", **AC_JAX, filters=(4, 8),
        save_dir=str(tmp_path / "jax"), extras={"fused_interpret": True})
    jwl = JAcousticWorkload.build(**AC_JAX, seed=0, water_rows=1)
    je = JAcousticEngine(jcfg, workload=jwl, mesh=jpar.make_mesh(4))
    assert je.physics_path == "fused+mesh"
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, je.params))
    ov = dict(AC_JAX, filters=(4, 8), save_dir=str(tmp_path / "torch"))
    got = _mesh_step(tmp_path, "marmousi_acoustic", ov, 4,
                     payload=(port_workload(jwl), state))
    assert str(got["physics_path"]) == "fused+mesh"
    jrec = je.optimize_parameters(1)
    _hold_jax(got, jrec, je.params, {"loss_D": "loss_D",
                                     "loss_M_MSE": "loss_M_MSE"}, 1e-5)


EL_JAX = dict(nz=36, nx=48, dx=15.0, nt=64, dt=0.0015, pml_width=8,
              freq=20.0, num_shots=4, num_receivers=10, water_rows=4,
              chunk=16)


@pytest.mark.parametrize("backend,base", [("auto", "fused"),
                                          ("fast", "fast")])
def test_elastic_engine_mesh_step_matches_jax_mesh_engine(tmp_path, backend,
                                                          base):
    """4 shots over 2 ranks against the JAX engine on
    ``jpar.make_mesh(2)`` (B3 in interpret mode on the fused path; on
    the fast path JAX divides each block by the global count and sums,
    the port averages the blocks' means): tests/test_torch_elastic_
    engine.py's workload with 4 shots, every shot each step (the two
    packages draw their shot order from different generators), the same
    weights, the misfit to 1e-4 as there."""
    cfg_kw = dict(EL_JAX, filters=(4, 8, 16), shots_per_iter=None,
                  lstart=0, grad_taper_rows=5, freq_stages=(15.0,),
                  backend=backend)
    jcfg = j_config.get_workload(
        "marmousi_elastic", **cfg_kw, save_dir=str(tmp_path / "jax"),
        extras={"fused_interpret": True})
    jwl = JElasticWorkload.build(**EL_JAX, seed=0)
    je = JElasticEngine(jcfg, workload=jwl, mesh=jpar.make_mesh(2))
    assert je.physics_path == base + "+mesh"
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, je.params))
    ov = dict(cfg_kw, save_dir=str(tmp_path / "torch"))
    got = _mesh_step(tmp_path, "marmousi_elastic", ov, 2,
                     payload=(port_elastic_workload(jwl), state))
    assert str(got["physics_path"]) == base + "+mesh"
    jrec = je.optimize_parameters(1)
    assert float(jrec["loss_D_MSE"]) > 0
    _hold_jax(got, jrec, je.params, {"loss_D_MSE": "loss_D_MSE",
                                     "loss_M_MSE": "loss_M_MSE"}, 1e-4)


def test_multi_sample_engine_mesh_step_matches_unsharded(tmp_path):
    """2 samples x 4 shots on a {sample, shot} mesh of 2 x 2."""
    ov = dict(SMALL_AC, num_shots=4, save_dir=str(tmp_path),
              engine="acoustic_dip_multi")
    got = _mesh_step(tmp_path, "marmousi_acoustic", ov, 4, mesh2d=(2, 2))
    ref = create_engine(config.get_workload("marmousi_acoustic", **ov),
                        device="cpu")
    assert ref.physics_path == "xla-loop"
    _hold(got, engine_step(ref), "sample-shot-sharded", ref.cfg.lr)


def test_train_with_a_mesh_writes_from_the_first_rank(tmp_path):
    """``train()`` on two ranks: the same history on each, and one
    rank's logs and checkpoints (one log line an epoch)."""
    ov = dict(SMALL_AC, save_dir=str(tmp_path / "runs"))
    d = tmp_path / "ranks"
    d.mkdir()
    np.savez(d / "in.npz", workload=np.array("marmousi_acoustic"),
             overrides=np.array(repr(ov)), epochs=np.array(2))
    spawn(run_check, 2, "train", str(d / "in.npz"), str(d), "cpu",
          device="cpu", store_dir=str(d))
    outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    np.testing.assert_array_equal(outs[0]["losses"], outs[1]["losses"])
    run = tmp_path / "runs" / "marmousi_acoustic"
    assert {"2_net_G.npz", "latest_net_G.npz", "train_opt.txt"} <= set(
        outs[0]["files"])
    with open(run / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2


def _cpu_mesh(shape):
    """A mesh object alone (no process group): enough for the checks an
    engine makes before it communicates."""
    axes = list(shape)
    return Mesh(shape, 0, {k: 0 for k in axes}, {k: None for k in axes},
                {k: list(range(v)) for k, v in shape.items()}, None, "cpu")


def test_engine_mesh_shape_errors(tmp_path):
    cfg = config.get_workload("marmousi_elastic", num_shots=10,
                              shots_per_iter=5, save_dir=str(tmp_path))
    with pytest.raises(ValueError, match="divisible"):
        ElasticDIPEngine(cfg, mesh=_cpu_mesh({"shot": 2}))
    cfg = config.get_workload("marmousi_acoustic", **SMALL_AC,
                              engine="acoustic_dip_multi")
    with pytest.raises(ValueError, match="sample, shot"):
        MultiSampleAcousticDIPEngine(cfg, mesh=_cpu_mesh({"shot": 2}))


def test_make_mesh_raises_without_a_card(tmp_path, monkeypatch):
    """Without a visible card a mesh made with no device raises, as the
    entry points do (the CPU only when the caller asks for it), so an
    engine given such a mesh never runs on the host unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with one_rank_mesh(tmp_path) as mesh:
        assert mesh.device == torch.device("cpu")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            t_mesh.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            t_mesh.make_mesh2d(1, 1)


def test_rank_device_under_a_mesh(monkeypatch):
    """Rank r's card is ``cuda:{LOCAL_RANK % cards}``, made current;
    :func:`default_device` is then the current card, and an engine given
    a mesh and no device takes the mesh's."""
    made = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", made.append)
    monkeypatch.setattr(t_mesh.dist, "get_rank", lambda: 3)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert t_mesh._rank_device("cuda") == torch.device("cuda", 1)
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setattr(t_mesh.dist, "get_rank", lambda: 2)
    assert t_mesh._rank_device("cuda") == torch.device("cuda", 0)
    assert made == [torch.device("cuda", 1), torch.device("cuda", 0)]
    assert t_mesh._rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert default_device() == torch.device("cuda", 1)
    assert _engine_device(None, None, _cpu_mesh({"shot": 2})) == \
        torch.device("cpu")


def test_launches_run_on_their_tensors_device(monkeypatch):
    """A kernel's C entry point runs with its tensors' card current (the
    entry points launch on, and ask about, the current device)."""
    seen = []

    class Ctx:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            seen.append(("enter", self.dev))

        def __exit__(self, *exc):
            seen.append(("exit", self.dev))

    class Lib:
        def pbfwi_probe(self, *args):
            seen.append(("call", args))
            return 0

    monkeypatch.setattr(torch.cuda, "device", Ctx)
    monkeypatch.setattr(cuda_build, "load_library", lambda: Lib())
    cuda_build.call(torch.device("cuda", 1), "pbfwi_probe", 7, 8)
    assert seen == [("enter", torch.device("cuda", 1)), ("call", (7, 8)),
                    ("exit", torch.device("cuda", 1))]
