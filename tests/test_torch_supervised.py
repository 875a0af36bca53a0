"""The supervised/GAN baselines (``SupervisedEngine``, ``train_supervised``,
the CLI) against the JAX package: two ``optimize_parameters`` steps of
``pix2pix_baseline`` (U-Net + PatchGAN), ``unet_ssim_baseline`` (L1 +
SSIM) and ``fno_baseline`` (FNO2d) at 32 x 32 from the JAX engine's
initial weights; then the port's batch loop over the JAX test's dataroot
(tests/test_engine.py::test_supervised_batch_epoch_loop: six 32 x 32
train and two test patches a letter) on the CPU, the B/D and B/D/E
letter combinations, the CLI and the checkpoints.

Adam's first step is lr * sign(gradient): an element whose gradient is
within the packages' difference of zero steps +-lr apart.  The L1 term's
gradient is sign(fake - b), which differs where the two packages' fakes
straddle the target, so such elements have gradients up to ~1e-3 of the
net's largest.  They (a handful) take the JAX engine's weight and Adam
moments between the two steps, as in tests/test_torch_acoustic_zoo.py.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.engines import (
    SupervisedEngine as JEngine,
)
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine import train as t_train
from physicsbasedfwi2_tpu_torch.engine.engines import (
    SupervisedEngine, create_engine,
)
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax

from torch_parity import t

torch.set_num_threads(1)

SHAPE = (32, 32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, batch=2):
    """Non-zero images (an all-zero input NaNs the GroupNorm nets at zero
    variance)."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.1, 1.0, (batch, *SHAPE, 1)).astype(np.float32)
            for _ in range(2)]


def _resync(port_net, port_opt, jparams, jadam, lr):
    """Elements whose first Adam step went the other way take the JAX
    engine's weight and moments.  Returns (elements, their largest
    |gradient| over the net's largest)."""
    jp = params_from_flax(_np(jparams))
    mu, nu = (params_from_flax(_np(m)) for m in (jadam.mu, jadam.nu))
    scale = max(float(p.grad.abs().max()) for p in port_net.parameters())
    count, worst = 0, 0.0
    with torch.no_grad():
        for name, p in port_net.named_parameters():
            flip = (p - jp[name]).abs() > lr
            if not flip.any():
                continue
            count += int(flip.sum())
            worst = max(worst, float(p.grad.abs()[flip].max()) / scale)
            p[flip] = jp[name][flip]
            state = port_opt.state[p]
            state["exp_avg"][flip] = mu[name][flip]
            state["exp_avg_sq"][flip] = nu[name][flip]
    return count, worst


def _rel_l2(port_net, jparams) -> float:
    jp = params_from_flax(_np(jparams))
    sd = port_net.state_dict()
    assert sd.keys() == jp.keys()
    num = sum(float(((sd[k] - jp[k]) ** 2).sum()) for k in sd)
    return (num / sum(float((v ** 2).sum()) for v in jp.values())) ** 0.5


@pytest.fixture(scope="module",
                params=["pix2pix_baseline", "unet_ssim_baseline",
                        "fno_baseline"])
def two_steps(request, tmp_path_factory):
    name = request.param
    root = tmp_path_factory.mktemp(name)
    jcfg = j_config.get_workload(name, save_dir=str(root / "jax"))
    cfg = config.get_workload(name, save_dir=str(root / "torch"))
    je = JEngine(jcfg, in_shape=SHAPE)
    pe = SupervisedEngine(cfg, in_shape=SHAPE, device="cpu")
    pe.net.load_state_dict(params_from_flax(_np(je.params)))
    if pe.use_gan:
        pe.disc.load_state_dict(params_from_flax(_np(je.d_params)))
    steps, resynced, drift = [], [], []
    for ep, seed in ((1, 0), (2, 1)):
        a, b = _images(seed)
        if ep == 2:
            resynced.append(_resync(pe.net, pe.opt, je.params,
                                    je.opt_state.inner_state[0], cfg.lr))
            if pe.use_gan:
                resynced.append(_resync(pe.disc, pe.d_opt, je.d_params,
                                        je.d_opt_state[0], cfg.lr))
        steps.append((je.optimize_parameters(a, b, epoch=ep),
                      pe.optimize_parameters(t(a), t(b), epoch=ep)))
        drift.append(_rel_l2(pe.net, je.params))
        if pe.use_gan:
            drift.append(_rel_l2(pe.disc, je.d_params))
    return dict(name=name, je=je, pe=pe, steps=steps, resynced=resynced,
                drift=drift, test=(je.test(*(_images(2))),
                                   pe.test(*(t(x) for x in _images(2)))))


def test_two_steps_match_jax(two_steps):
    pe = two_steps["pe"]
    keys = {"loss_G", "lr"} | ({"loss_D"} if pe.use_gan else set())
    for jrec, prec in two_steps["steps"]:
        assert jrec.keys() == prec.keys() == keys
        for k in keys:
            # float32 forward and backward: 1e-5 relative
            np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5,
                                       err_msg=k)
    # the weights after each step (G, then D): relative L2 1e-4 of the
    # JAX engine's
    assert max(two_steps["drift"]) <= 1e-4, two_steps["drift"]
    n_params = sum(p.numel() for p in pe.net.parameters())
    for count, worst in two_steps["resynced"]:
        assert count <= 1e-3 * n_params and worst <= 2e-3
    (jv, jimg), (pv, pimg) = two_steps["test"]
    assert jv.keys() == pv.keys() == {"loss_V_L1"}
    np.testing.assert_allclose(pv["loss_V_L1"], jv["loss_V_L1"], rtol=1e-4)
    np.testing.assert_allclose(pimg, np.asarray(jimg), rtol=0,
                               atol=1e-4 * float(np.abs(jimg).max()))


def test_engine_shape_of_each_workload(two_steps):
    """unet_128 and FNO keep the input's size; the discriminator (pix2pix)
    is the 3-layer PatchGAN at base 32 on [a, fake], and its Adam keeps
    the constant cfg.lr while the generator's follows the policy."""
    pe, name = two_steps["pe"], two_steps["name"]
    assert pe.use_gan == (name == "pix2pix_baseline")
    if pe.use_gan:
        assert pe.disc.convs[0].in_channels == 2
        assert [c.out_channels for c in pe.disc.convs] == [32, 64, 128, 256]
        assert [g["lr"] for g in pe.d_opt.param_groups] == [pe.cfg.lr]
        assert pe.d_opt.defaults["betas"] == (pe.cfg.beta1, 0.999)
    assert type(pe.net).__name__ == ("FNO2d" if name == "fno_baseline"
                                     else "UNet")


def _write_tree(root, letters="AB", phases=(("train", 6), ("test", 2)),
                rng=None):
    """The JAX test's dataroot: uniform(0.1, 1) 32 x 32 patches."""
    rng = rng or np.random.default_rng(0)
    for phase, count in phases:
        for L in letters:
            d = root / (phase + L)
            d.mkdir()
            for i in range(count):
                np.save(d / f"{i}.npy", rng.uniform(
                    0.1, 1.0, SHAPE).astype(np.float32))
    return rng


def test_train_supervised_from_a_dataroot(tmp_path, capsys):
    rng = _write_tree(tmp_path)
    cfg = config.get_workload(
        "pix2pix_baseline", name="t_sup_loop", dataroot=str(tmp_path),
        save_dir=str(tmp_path / "ck"), batch_size=3, n_epochs=2,
        save_epoch_freq=1)
    eng, hist = t_train.train(cfg, epochs=2, quiet=True, device="cpu")
    assert isinstance(eng, SupervisedEngine) and eng.device.type == "cpu"
    assert [h["epoch"] for h in hist] == [1, 2]
    for h in hist:
        assert h.keys() == {"epoch", "loss_G", "loss_D", "lr", "epoch_time",
                            "loss_V_L1"}
        assert all(np.isfinite(v) for v in h.values())
    assert os.path.exists(tmp_path / "ck" / "t_sup_loop" / "loss_log.txt")
    for tag in (1, 2, "latest"):
        assert os.path.exists(tmp_path / "ck" / "t_sup_loop"
                              / f"{tag}_net_G.npz")
    # the CLI on the CPU
    t_train.main(["--workload", "pix2pix_baseline", "--dataroot",
                  str(tmp_path), "--epochs", "1", "--name", "t_sup_cli",
                  "--save-dir", str(tmp_path / "ck"), "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["epoch"] == 1 and np.isfinite(rec["loss_G"])
    assert "loss_V_L1" in rec
    # multi-channel letters; no testD/testE twin, so no validation
    _write_tree(tmp_path, "DE", (("train", 4),), rng)
    for wl, n_in in (("pix2pix_bd", 1), ("pix2pix_bde", 2)):
        cfg = config.get_workload(wl, name=f"t_{wl}", dataroot=str(tmp_path),
                                  save_dir=str(tmp_path / "ck"),
                                  batch_size=2, n_epochs=1)
        eng, hist = t_train.train(cfg, epochs=1, quiet=True, device="cpu")
        assert np.isfinite(hist[-1]["loss_G"]), wl
        assert "loss_V_L1" not in hist[-1], wl
        # B (+ E) in, D out: the first conv takes n_in channels, the
        # discriminator n_in + 1
        assert eng.net.blocks[0].convs[0].in_channels == n_in, wl
        assert eng.disc.convs[0].in_channels == n_in + 1, wl


def test_supervised_needs_a_dataroot_and_two_letters(tmp_path):
    cfg = config.get_workload("pix2pix_baseline")
    with pytest.raises(ValueError, match="dataroot"):
        t_train.train_supervised(cfg, device="cpu")
    _write_tree(tmp_path, "A", (("train", 2),))
    with pytest.raises(ValueError, match="input\\+target"):
        t_train.train_supervised(cfg.replace(dataroot=str(tmp_path)),
                                 device="cpu")


def test_no_card_no_quiet_cpu_fallback(tmp_path, monkeypatch):
    """Without ``device`` the engine, the loop and the CLI take the card,
    and raise where none is visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_tree(tmp_path, "AC")   # unalignedAC2's letters
    cfg = config.get_workload("unet_ssim_baseline", dataroot=str(tmp_path),
                              save_dir=str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        create_engine(cfg, in_shape=SHAPE)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_train.train(cfg, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_train.main(["--workload", "unet_ssim_baseline", "--dataroot",
                      str(tmp_path), "--epochs", "1"])


def test_checkpoints_round_trip_and_cross_packages(two_steps, tmp_path):
    """save_networks writes the generator alone, with the JAX keys; it
    loads back bit for bit in the port and in the JAX engine."""
    je, pe = two_steps["je"], two_steps["pe"]
    path = pe.save_networks("rt")
    with np.load(path) as z:
        keys = set(z.files)
    flat = {jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_leaves_with_path(je.params)}
    assert keys == flat
    before = {k: v.clone() for k, v in pe.net.state_dict().items()}
    with torch.no_grad():
        for p in pe.net.parameters():
            p.add_(1.0)
    pe.load_networks("rt")
    for k, v in pe.net.state_dict().items():
        assert torch.equal(v, before[k]), k
    os.makedirs(je._dir(), exist_ok=True)
    os.replace(path, os.path.join(je._dir(), "rt_net_G.npz"))
    je.load_networks("rt")
    jp = params_from_flax(_np(je.params))
    for k, v in before.items():
        assert torch.equal(jp[k], v), k
