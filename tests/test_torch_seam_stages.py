"""``seam_elastic_robust`` on the port against the JAX engine across its
frequency stages: both packages' ``train`` from the same generator
weights on SEAM's acquisition rows (sources on row 6, receivers on row
23, a free surface) with DENISE's EPRECOND weight, the step cap, the
held-out shots and the drift guard, through two stage changes into the
final stage, where ``step_cap_final=0`` releases the cap.

Shrunk as ``test_torch_elastic_robust.py`` shrinks the robust recipe:
36 x 48 at dx 15 m, nt 64, 5 shots (3 held out), three stages of at
most two epochs.  The JAX engine runs its fused path in interpret mode
(``extras={"fused_interpret": True}``) on the same numpy workload; both
train on the whole pool each epoch (``shots_per_iter=None``), so the
misfit does not depend on which generator draws the shots.
"""

import jax
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticElasticWorkload as JWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import ElasticDIPEngine as JEngine
from physicsbasedfwi2_tpu.engine.train import train as j_train
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine.engines import ElasticDIPEngine
from physicsbasedfwi2_tpu_torch.engine.train import train
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax

from torch_parity import n, port_elastic_workload

torch.set_num_threads(1)

ROWS = dict(src_depth_row=6, rcv_depth_row=23)  # SEAM's rows
WL = dict(nz=36, nx=48, dx=15.0, nt=64, dt=0.0015, pml_width=8,
          freq=20.0, num_shots=5, num_receivers=10, seed=0, water_rows=4,
          chunk=16)
STAGES = (10.0, 15.0, 20.0)
# seam_elastic_robust's recipe (EPRECOND, step cap 1 m/s RMS released in
# the final stage, 3 held-out shots, the drift guard) with a loss_H every
# epoch and stages of at most two epochs; the guard's patience and
# tolerance are cut so that it fires within the run
CFG = dict(WL, filters=(4, 8, 16), shots_per_iter=None, lstart=1,
           grad_taper_rows=5, freq_stages=STAGES, stage_max_epochs=2,
           holdout_every=1, guard_patience=1, guard_tol=1.0,
           guard_lr_ramp=3)
EPOCHS = 7


def _rms(a, b) -> float:
    return float(np.sqrt(np.mean((n(a) - n(b)) ** 2)))


@pytest.fixture(scope="module")
def seam_stages(tmp_path_factory):
    root = tmp_path_factory.mktemp("seam_stages")
    jcfg = j_config.get_workload(
        "seam_elastic_robust", **CFG, save_dir=str(root / "jax"),
        extras=dict(ROWS, fused_interpret=True))
    cfg = config.get_workload("seam_elastic_robust", **CFG,
                              extras=dict(ROWS), save_dir=str(root / "torch"))
    jwl = JWorkload.build(**{k: v for k, v in WL.items() if k != "seed"},
                          seed=0, **ROWS)
    pwl = port_elastic_workload(jwl)
    je = JEngine(jcfg, workload=jwl)
    pe = ElasticDIPEngine(cfg, workload=pwl, device="cpu")
    pe.net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, je.params)))
    moves = {"jax": [], "port": []}
    models = {"jax": [], "port": []}   # each step's model before and after
    restored = {"jax": [], "port": []}

    def spy(eng, key, decode):
        step, revert = eng.optimize_parameters, eng.guard_revert

        def optimize_parameters(epoch, **kw):
            m0 = n(decode())
            out = step(epoch, **kw)
            m1 = n(decode())
            moves[key].append(_rms(m1, m0))
            models[key].append((m0, m1))
            return out

        def guard_revert(params, epoch):
            revert(params, epoch)
            restored[key].append(n(decode()))

        eng.optimize_parameters = optimize_parameters
        eng.guard_revert = guard_revert

    spy(je, "jax", lambda: je._sample_model(je.params)[0])
    spy(pe, "port", lambda: pe._sample_model()[0])
    _, jh = j_train(je.cfg, epochs=EPOCHS, quiet=True, engine=je)
    _, ph = train(pe.cfg, epochs=EPOCHS, quiet=True, engine=pe)
    return dict(je=je, pe=pe, jh=jh, ph=ph, moves=moves, models=models,
                restored=restored)


def test_recipe_and_rows(seam_stages):
    pe = seam_stages["pe"]
    c = pe.cfg
    assert (c.grad_illum_eps, c.step_cap, c.step_cap_final,
            c.holdout_shots, c.tether_weight, c.phase_reset_opt) == (
        0.05, 1.0, 0.0, 3, 0.0, True)
    assert pe.physics_path == "fused-plain"
    assert pe.wl.grid.free_surface
    assert pe.wl.acq.src_z.tolist() == [6] * 5
    assert np.all(pe.wl.acq.rcv_z == 23)


def test_stages_match_jax(seam_stages):
    jh, ph = seam_stages["jh"], seam_stages["ph"]
    # two epochs a stage, the warmup's in the first: two stage changes
    assert [r["freq_stage"] for r in ph] == [r["freq_stage"] for r in jh]
    assert [r["freq_stage"] for r in ph] == [10.0, 10.0, 15.0, 15.0, 20.0,
                                             20.0, 20.0]
    for k in ("guard_revert", "selected_epoch"):
        assert [r.get(k) for r in ph] == [r.get(k) for r in jh], k


def test_records_match_jax(seam_stages):
    jh, ph = seam_stages["jh"], seam_stages["ph"]
    for ep, (jrec, prec) in enumerate(zip(jh, ph), start=1):
        keys = {"loss_D_MSE", "loss_M_MSE", "loss_V_MSE"}
        if ep > CFG["lstart"]:
            keys.add("loss_H")
        assert keys <= jrec.keys() and keys <= prec.keys()
        for k in keys:
            assert np.isfinite(prec[k])
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-4,
                                       err_msg=f"epoch {ep} {k}")


def test_models_match_jax_every_step(seam_stages):
    """Each step's model, before and after, to 1e-5 of max: float32 sums
    in another order through the generator leave a few ulps of a ~4000
    m/s model (about 1e-3 m/s RMS), from the first step on, and the
    difference does not grow across the stages."""
    models = seam_stages["models"]
    assert len(models["port"]) == len(models["jax"]) == EPOCHS
    for (j0, j1), (p0, p1) in zip(models["jax"], models["port"]):
        for j, p in ((j0, p0), (j1, p1)):
            assert np.max(np.abs(p - j)) <= 1e-5 * np.max(np.abs(j))


def test_moves_match_jax(seam_stages):
    """The model moves to rtol 1e-3, beside the part of a move that the
    two models' own float32 difference accounts for (rms(p0 - j0) +
    rms(p1 - j1)): a capped move is 1 m/s RMS, so that part is ~1e-3 of
    it, while the warmup's and the final stage's moves (60-80 m/s) agree
    to rtol 1e-3 on their own."""
    moves, models = seam_stages["moves"], seam_stages["models"]
    noise = [_rms(p0, j0) + _rms(p1, j1)
             for (j0, j1), (p0, p1) in zip(models["jax"], models["port"])]
    for mp, mj, e in zip(moves["port"], moves["jax"], noise):
        assert abs(mp - mj) <= 1e-3 * mj + e, (mp, mj, e)
    # the cap (1 m/s RMS) holds the physics epochs up to the first record
    # of the final stage, and the next one, uncapped, moves past it in both
    first = [r["freq_stage"] for r in seam_stages["ph"]].index(20.0) + 1
    assert all(mv <= 1.2 for mv in moves["port"][1:first])
    assert moves["port"][first] > 10.0 and moves["jax"][first] > 10.0
    big = [(mp, mj) for mp, mj in zip(moves["port"], moves["jax"])
           if mj > 10.0]
    assert len(big) == 3
    np.testing.assert_allclose(*zip(*big), rtol=1e-3)


def test_guard_restores_the_same_snapshot(seam_stages):
    restored = seam_stages["restored"]
    # the guard fires in the capped stages and in the final one
    assert len(restored["port"]) == len(restored["jax"]) >= 2
    for mp, mj in zip(restored["port"], restored["jax"]):
        assert np.max(np.abs(mp - mj)) <= 1e-5 * np.max(np.abs(mj))
