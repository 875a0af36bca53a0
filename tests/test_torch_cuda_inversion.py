"""The elastic recipes invert on a CUDA card at full width and full
budget (the counterpart of ``tpu_tests/test_elastic_inversion_tpu.py``).

After the registered physics budget the vp + vs model MSE must land
below the low-frequency starting model (the record at the end of the
``lstart`` warmup).  Only a full-size run can show this: at the tiny CPU
shapes the problem is not unique (the data misfit falls while the model
worsens).

- ``marmousi_elastic``, 300 epochs on its synthetic workload (as the JAX
  test runs it): at least 3 continuation stages, final < 0.98 x start.
- ``marmousi_elastic_real``, 1000 epochs on the known-density Marmousi
  tree: at least 4 stages, final < 0.75 x start (docs/RESULTS.md records
  5,613 against 11,175 at epoch 1000 for the JAX package, 0.50 x).
- ``marmousi_elastic_robust`` seeds 1 and 2, 1500 epochs, and
  ``seam_elastic_robust``, 600 epochs, on their known-density trees:
  final < start, and the robust recipe's ``selected`` checkpoint saved.
  The JAX test's gates for these (0.6 x, 0.65 x and 0.8 x) cite runs
  that do not exist (VERDICT.md:190-209: the one recorded robust run
  ended at 0.903 x, the SEAM run at 0.957 x); these are the gates those
  records support.

The trees are prepped here under a temporary directory, as a user would:
``data/marmousi.py`` (procedural, nothing downloaded) writes the
canonical Marmousi (751 x 2301) or SEAM (600 x 1620) stand-in as SEG-Y,
then ``data.prep --physics elastic --rho-start true`` resamples it and
simulates the gathers on the card.  Each test prints its measured ratio
and has its own time limit.  These need the card and skip elsewhere;
on a machine without JAX run them with ``--noconftest``:
``python -m pytest tests/test_torch_cuda_inversion.py --noconftest -m
cuda -s``.
"""

import pytest
import torch

from physicsbasedfwi2_tpu_torch.data import marmousi, prep
from physicsbasedfwi2_tpu_torch.engine.config import get_workload
from physicsbasedfwi2_tpu_torch.engine.train import train

from torch_parity import deadline

pytestmark = [pytest.mark.cuda, pytest.mark.slow]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def marm_kd(dev, tmp_path_factory):
    """The known-density Marmousi tree (100 x 300, 35 shots, nt 3334):
    README's ``fwi-prep --physics elastic --rho-start true --nz 100
    --nx 300``."""
    root = tmp_path_factory.mktemp("marm")
    segy = root / "marm751x2301.segy"
    marmousi.main(["--out", str(segy)])
    prep.main(["--grid", str(segy), "--physics", "elastic", "--rho-start",
               "true", "--nz", "100", "--nx", "300", "--out",
               str(root / "marm_elastic_kd")])
    return str(root / "marm_elastic_kd")


@pytest.fixture(scope="module")
def seam_kd(dev, tmp_path_factory):
    """The known-density SEAM tree at ``seam_elastic``'s geometry (120 x
    324 at dx 30 m, 38 shots, nt 2568, sources on row 6, receivers on row
    23; docs/RESULTS.md's ``seam_elastic_kd``)."""
    cfg = get_workload("seam_elastic_robust")
    root = tmp_path_factory.mktemp("seam")
    segy = root / "seam600x1620.segy"
    marmousi.main(["--out", str(segy), "--model", "seam"])
    prep.main(["--grid", str(segy), "--physics", "elastic", "--rho-start",
               "true", "--nz", str(cfg.nz), "--nx", str(cfg.nx), "--dx",
               str(cfg.dx), "--nt", str(cfg.nt), "--dt", str(cfg.dt),
               "--freq", str(cfg.freq), "--num-shots", str(cfg.num_shots),
               "--num-receivers", str(cfg.num_receivers), "--water-rows",
               str(cfg.water_rows), "--src-depth-row",
               str(cfg.extras["src_depth_row"]), "--rcv-depth-row",
               str(cfg.extras["rcv_depth_row"]), "--out",
               str(root / "seam_elastic_kd")])
    return str(root / "seam_elastic_kd")


def _invert(dev, tmp_path, workload, epochs, limit_s, **overrides):
    """Train ``workload`` for ``epochs`` on the card within ``limit_s``;
    returns (config, history, start MSE, final MSE, stages seen)."""
    cfg = get_workload(workload, name=f"inv_{workload}",
                       save_dir=str(tmp_path), save_epoch_freq=10 ** 9,
                       **overrides)
    with deadline(limit_s):
        engine, history = train(cfg, epochs=epochs, quiet=True, device=dev)
    start = next(r["loss_M_MSE"] for r in history
                 if r["epoch"] == cfg.lstart)
    final = history[-1]["loss_M_MSE"]
    stages = sorted({r["freq_stage"] for r in history})
    secs = sum(r["epoch_time"] for r in history)
    # the trajectory: every 100th epoch, each stage's first and each
    # drift-guard revert
    prev = None
    for r in history:
        if (r["epoch"] % 100 == 0 or r["freq_stage"] != prev
                or "guard_revert" in r):
            extra = "".join(f", {k} {r[k]:.5g}" for k in ("loss_D_MSE",
                                                           "loss_H")
                            if k in r)
            print(f"  {workload} epoch {r['epoch']}: stage "
                  f"{r['freq_stage']}, model MSE {r['loss_M_MSE']:.1f} "
                  f"({r['loss_M_MSE'] / start:.3f} x start){extra}"
                  f"{', guard revert' if 'guard_revert' in r else ''}")
        prev = r["freq_stage"]
    print(f"{workload} {overrides}: path {engine.physics_path}; {epochs} "
          f"epochs in {secs:.1f} s; model MSE start {start:.1f} (epoch "
          f"{cfg.lstart}), final {final:.1f}, ratio {final / start:.4f}; "
          f"best {min(r['loss_M_MSE'] for r in history):.1f}; stages "
          f"{stages}; card {torch.cuda.get_device_name(dev)}")
    return cfg, history, start, final, stages


def _selected(cfg, history, tmp_path):
    """The ``selected`` checkpoint was saved; prints its epoch's ratio."""
    epochs = [r["selected_epoch"] for r in history if "selected_epoch" in r]
    assert epochs, "no selected checkpoint was saved"
    assert (tmp_path / cfg.name / "selected_net_G.npz").exists()
    start = next(r["loss_M_MSE"] for r in history
                 if r["epoch"] == cfg.lstart)
    sel = history[epochs[-1] - 1]["loss_M_MSE"]
    print(f"{cfg.name}: selected epoch {epochs[-1]}, model MSE {sel:.1f}, "
          f"ratio {sel / start:.4f}")


def test_elastic_flagship_beats_starting_model(dev, tmp_path):
    _, _, start, final, stages = _invert(dev, tmp_path, "marmousi_elastic",
                                         300, 600)
    assert len(stages) >= 3, stages
    assert final < 0.98 * start, (final, start)


def test_elastic_real_flagship_inverts(dev, tmp_path, marm_kd):
    _, _, start, final, stages = _invert(
        dev, tmp_path, "marmousi_elastic_real", 1000, 1200, dataroot=marm_kd)
    assert len(stages) >= 4, stages
    assert final < 0.75 * start, (final, start)


@pytest.mark.parametrize("seed", [1, 2])
def test_elastic_robust_recipe_inverts(dev, tmp_path, marm_kd, seed):
    cfg, history, start, final, _ = _invert(
        dev, tmp_path, "marmousi_elastic_robust", 1500, 1500, seed=seed,
        dataroot=marm_kd)
    _selected(cfg, history, tmp_path)
    assert final < start, (final, start)


def test_seam_robust_inverts(dev, tmp_path, seam_kd):
    cfg, history, start, final, _ = _invert(
        dev, tmp_path, "seam_elastic_robust", 600, 1200, dataroot=seam_kd)
    _selected(cfg, history, tmp_path)
    assert final < start, (final, start)
