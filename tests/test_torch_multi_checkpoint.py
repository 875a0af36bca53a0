"""The multi-sample acoustic engine (``engine="acoustic_dip_multi"``)
against the JAX engine on the same two numpy workloads and generator
weights, and full-state checkpoints (``engine/checkpoint.py``) of every
kind of engine and optimizer the port trains."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticAcousticWorkload as JWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import (
    MultiSampleAcousticDIPEngine as JMulti,
)
from physicsbasedfwi2_tpu_torch.data.synthetic import (
    SyntheticAcousticWorkload,
)
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine import engines as t_engines
from physicsbasedfwi2_tpu_torch.engine.checkpoint import (
    restore_engine, save_engine,
)
from physicsbasedfwi2_tpu_torch.engine.engines import (
    MultiSampleAcousticDIPEngine, _Lbfgs, create_engine,
)
from physicsbasedfwi2_tpu_torch.engine.train import train
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax
from physicsbasedfwi2_tpu_torch.optim.lbfgs import LbfgsOptState

from torch_parity import one_rank_mesh, port_workload, rel_max, t

torch.set_num_threads(1)

# tests/test_engine.py's SMALL_AC
SMALL_AC = dict(nz=40, nx=48, nt=400, dt=0.001, num_shots=4,
                num_receivers=24, filters=(4, 8, 16), chunk=25,
                water_rows=6, pml_width=12)


@pytest.fixture(scope="module")
def jwls():
    return [JWorkload.build(nz=40, nx=48, nt=400, dt=0.001, num_shots=4,
                            num_receivers=24, chunk=25, water_rows=6,
                            pml_width=12, seed=s) for s in (0, 1)]


@pytest.mark.parametrize("direct_wave", [True, False])
def test_multi_sample_warmup_then_physics_match_jax(jwls, tmp_path,
                                                    direct_wave):
    kw = dict(SMALL_AC, save_dir=str(tmp_path), engine="acoustic_dip_multi",
              lstart=1, direct_wave=direct_wave)
    jcfg = j_config.get_workload("marmousi_acoustic", **kw)
    cfg = config.get_workload("marmousi_acoustic", **kw)
    je = JMulti(jcfg, workloads=[dataclasses.replace(w) for w in jwls])
    # the port builds with the JAX engine's direct wave: normalized over
    # the shots, the direct-removed gathers' early samples are rounding
    # noise scaled to O(1), so they must be the same bits on both sides
    # (ROADMAP Queue C)
    with pytest.MonkeyPatch.context() as mp:
        if direct_wave:
            mp.setattr(t_engines, "simulate_acoustic",
                       lambda *a, **k: t(je._direct))
        pe = MultiSampleAcousticDIPEngine(
            cfg, workloads=[port_workload(w) for w in jwls], device="cpu")
    assert (pe._direct is None) == (je._direct is None) == (not direct_wave)
    assert pe.physics_path == "xla-loop"
    # the observed batch, normalized over its axis 1 as in the JAX engine
    # (equal but for the subnormals XLA flushes on the CPU)
    assert rel_max(pe.obs_norm, je.obs_norm) <= 1e-6
    pe.net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, je.params)))
    for ep, key in ((1, "loss_M"), (2, "loss_D")):
        jrec, prec = je.optimize_parameters(ep), pe.optimize_parameters(ep)
        assert jrec.keys() == prec.keys() == {key, "loss_M_MSE", "lr"}
        for k in jrec:
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5,
                                       err_msg=f"epoch {ep} {k}")
    (jv, jm), (pv, pm) = je.test(), pe.test()
    assert pm.shape == jm.shape == (2, 40, 48)
    np.testing.assert_allclose(pv["loss_V_MSE"], jv["loss_V_MSE"],
                               rtol=1e-4)


def test_multi_sample_direct_wave_toggle_changes_the_loss(tmp_path):
    kw = dict(SMALL_AC, nt=200, save_dir=str(tmp_path),
              engine="acoustic_dip_multi")
    cfg = config.get_workload("marmousi_acoustic", **kw)
    losses = {}
    for on in (True, False):
        e = create_engine(cfg.replace(direct_wave=on), device="cpu")
        assert isinstance(e, MultiSampleAcousticDIPEngine)
        assert len(e.wls) == 2 and e.shots_in.shape[0] == 2
        losses[on] = e.optimize_parameters(1)["loss_D"]
    assert all(np.isfinite(v) for v in losses.values())
    assert abs(losses[True] - losses[False]) > 1e-9
    # ported since: a {sample, shot} mesh; a 1-D one is refused
    with one_rank_mesh(tmp_path) as mesh:
        with pytest.raises(ValueError, match="sample, shot"):
            MultiSampleAcousticDIPEngine(cfg, mesh=mesh, device="cpu")


# -- full-state checkpoints ---------------------------------------------

CK = dict(SMALL_AC, nt=200, validate_on_twin=False)
CASES = {
    "acoustic_adam": ("marmousi_acoustic", {}),
    "acoustic_sgld": ("marmousi_acoustic", {"optimizer": "sgld"}),
    "encoded_lbfgs": ("marmousi_acoustic_encoded",
                      {"optimizer": "lbfgs", "encoded_shots": 2}),
    "classic_lbfgs": ("classic_fwi_acoustic", {"optimizer": "lbfgs"}),
    "latent_adam": ("latent_inversion", {}),
    "impedance_adam": ("marmousi_impedance", {}),
    "multi_sghmc": ("marmousi_acoustic", {"engine": "acoustic_dip_multi",
                                          "optimizer": "sghmc"}),
}


def _state_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_state_equal, a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b) and a.dtype == b.dtype
    return a == b and type(a) is type(b)


def _opt_state(opt):
    if isinstance(opt, _Lbfgs):
        return [getattr(opt.state, f.name)
                for f in dataclasses.fields(LbfgsOptState)]
    return opt.state_dict()


@pytest.fixture(scope="module")
def ck_workload():
    return SyntheticAcousticWorkload.build(
        **{k: CK[k] for k in ("nz", "nx", "nt", "dt", "num_shots",
                              "num_receivers", "chunk", "water_rows",
                              "pml_width")}, seed=0, device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoint_round_trip(case, ck_workload, tmp_path):
    """save_engine, then restore_engine into a fresh engine: the weights
    and the optimizer state are equal, the epoch comes back, and the next
    step of both engines is the same to the bit."""
    name, over = CASES[case]
    cfg = config.get_workload(name, **CK, save_dir=str(tmp_path), **over)

    def build():
        kw = ({} if cfg.engine == "acoustic_dip_multi" else
              {"workload": dataclasses.replace(ck_workload)})
        return create_engine(cfg, device="cpu", **kw)

    torch.manual_seed(0)
    a = build()
    a.optimize_parameters(1)
    path = str(tmp_path / "state.pt")
    save_engine(a, path, epoch=1)
    b = build()
    assert restore_engine(b, path) == 1
    for (ka, va), (kb, vb) in zip(a.weights.state_dict().items(),
                                  b.weights.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    assert _state_equal(_opt_state(a.opt), _opt_state(b.opt))
    if getattr(a.opt, "generator", None) is not None:
        assert torch.equal(a.opt.generator.get_state(),
                           b.opt.generator.get_state())
    if getattr(a, "_enc_gen", None) is not None:
        b._enc_gen.set_state(a._enc_gen.get_state())
    assert a.optimize_parameters(2) == b.optimize_parameters(2)


def test_train_and_save_of_each_new_engine(ck_workload, tmp_path):
    """train(..., epochs=2) completes and saves for every new engine;
    without a card and without a device, building one raises."""
    for name, over in (("latent_inversion", {}),
                       ("classic_fwi_acoustic", {}),
                       ("classic_fwi_elastic", {"dt": 0.0015,
                                                "shots_per_iter": 2}),
                       ("marmousi_impedance", {}),
                       ("marmousi_acoustic_encoded", {"encoded_shots": 2}),
                       ("marmousi_acoustic",
                        {"engine": "acoustic_dip_multi", "lstart": 1})):
        cfg = config.get_workload(name, **{**CK, **over},
                                  save_dir=str(tmp_path))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA card"):
                create_engine(cfg)
        kw = ({} if cfg.engine == "acoustic_dip_multi"
              or name == "classic_fwi_elastic" else
              {"workload": dataclasses.replace(ck_workload)})
        _, hist = train(cfg, epochs=2, quiet=True, device="cpu", **kw)
        assert len(hist) == 2
        assert all(np.isfinite(v) for r in hist for v in r.values()
                   if isinstance(v, float)), name
        assert (tmp_path / cfg.name / "latest_net_G.npz").exists()
