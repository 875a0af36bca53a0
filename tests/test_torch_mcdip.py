"""MC dropout on the port (``mcdip_uq``, BASELINE config 5): the
AutoElMarMCDIP22 generator against Flax's under identical dropout masks,
the dropout statistics, the elastic engine's training decodes and
``mc_realizations``, ``evaluate(realizations=N)`` against the JAX
package's keys, and the ``fwi-test --realization`` CLI.

Flax's masks are captured with ``flax.linen.intercept_methods`` around
each ``nn.Dropout`` call (a kept element is a nonzero output) and fed, in
call order, to the port's ``blocks.dropout_mask`` through ``monkeypatch``.
"""

import json
import math
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticElasticWorkload as JWorkload,
)
from physicsbasedfwi2_tpu.engine import config as j_config
from physicsbasedfwi2_tpu.engine.test import evaluate as j_evaluate
from physicsbasedfwi2_tpu.models import define_generator as j_define
from physicsbasedfwi2_tpu_torch.engine import config
from physicsbasedfwi2_tpu_torch.engine.engines import (
    AcousticDIPEngine, ElasticDIPEngine,
)
from physicsbasedfwi2_tpu_torch.engine.test import evaluate
from physicsbasedfwi2_tpu_torch.models import blocks, define_generator
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax

from torch_parity import port_elastic_workload, rel_max, t

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTERS = (4, 8, 16)
OUT = (20, 24)
IN = (1, 64, 16, 3)  # [B, nt, nr, ns]
# dropout sites: one a decoder's up block, two decoders
SITES = 2 * (len(FILTERS) - 1)
# the engine tests' size (the CLI's --small grid, fewer time steps)
SMALL = dict(nz=40, nx=48, nt=120, num_shots=3, num_receivers=16,
             filters=FILTERS, water_rows=6, lstart=1)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(1)
    xv, xz = (rng.standard_normal(IN).astype(np.float32) for _ in range(2))
    jnet = j_define("AutoElMarMCDIP22", out_shape=OUT, filters=FILTERS)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(xv), jnp.asarray(xz)))
    net = define_generator("AutoElMarMCDIP22", out_shape=OUT,
                           in_shape=IN[1:], filters=FILTERS)
    net.load_state_dict(params_from_flax(params))
    return jnet, params, net, xv, xz


def _recorder(masks):
    """A ``blocks.dropout_mask`` that records each mask it draws."""
    draw = blocks.dropout_mask

    def record(x, keep, generator):
        m = draw(x, keep, generator)
        masks.append(m.clone())
        return m

    return record


def test_generator_matches_flax_under_identical_masks(nets, monkeypatch):
    jnet, params, net, xv, xz = nets
    masks = []

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if (isinstance(context.module, fnn.Dropout)
                and context.method_name == "__call__"):
            masks.append(np.asarray(out) != 0)
        return out

    with fnn.intercept_methods(capture):
        jf, jz = jnet.apply(params, jnp.asarray(xv), jnp.asarray(xz),
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(3)})
    jdet, _ = jnet.apply(params, jnp.asarray(xv), jnp.asarray(xz))
    # 2 up blocks a decoder at these filters, 2 decoders: each site drops
    # ~10 %
    assert len(masks) == SITES == 4
    dropped = np.mean([1.0 - m.mean() for m in masks])
    assert 0.05 < dropped < 0.15
    fed = iter(masks)

    def from_flax(x, keep, generator):
        m = torch.as_tensor(next(fed)).permute(0, 3, 1, 2)  # NHWC -> NCHW
        assert m.shape == x.shape and keep == pytest.approx(0.9)
        return m

    monkeypatch.setattr(blocks, "dropout_mask", from_flax)
    with torch.no_grad():
        f, z = net(t(xv), t(xz), deterministic=False,
                   generator=torch.Generator())
        fdet, _ = net(t(xv), t(xz))
    assert next(fed, None) is None  # every captured mask was used
    assert f.shape == jf.shape == (1, *OUT, 2)
    assert rel_max(f, jf) <= 1e-5
    assert rel_max(z, jz) <= 1e-5
    assert rel_max(fdet, jdet) <= 1e-5
    # the masks matter: the sampled fields are not the deterministic ones
    assert rel_max(jf, jdet) > 1e-2


def test_dropout_statistics():
    g = torch.Generator().manual_seed(0)
    x = torch.rand(400_000, generator=g) + 0.5
    y = blocks.dropout(x, 0.1, deterministic=False, generator=g)
    kept = y != 0
    frac = float(kept.float().mean())
    assert abs(frac - 0.9) <= 3.0 * math.sqrt(0.9 * 0.1 / x.numel())
    # kept values are scaled by 1 / 0.9 and nothing else
    assert torch.equal(y[kept], (x / 0.9)[kept])
    ratio = (y[kept].double() / x[kept].double())
    assert float((ratio - 1.0 / 0.9).abs().max()) <= 2e-7
    # deterministic, rate 0: the input itself; rate 1: zeros; sampling
    # needs a generator
    assert blocks.dropout(x, 0.1, deterministic=True, generator=g) is x
    assert blocks.dropout(x, 0.0, deterministic=False, generator=g) is x
    assert not blocks.dropout(x, 1.0, deterministic=False,
                              generator=g).any()
    with pytest.raises(ValueError, match="Generator"):
        blocks.dropout(x, 0.1, deterministic=False, generator=None)


def test_deterministic_net_equals_the_dropout_free_net(nets):
    _, _, net, xv, xz = nets
    plain = define_generator("AutoElMar22", out_shape=OUT, in_shape=IN[1:],
                             filters=FILTERS)
    plain.load_state_dict(net.state_dict())
    with torch.no_grad():
        a, za = net(t(xv), t(xz))
        b, zb = plain(t(xv), t(xz))
    assert torch.equal(a, b) and torch.equal(za, zb)
    n_sites = sum(isinstance(m, blocks.ConvBlock) and m.dropout == 0.1
                  for m in net.modules())
    assert n_sites == SITES
    # at the registered filters, 3 up blocks a decoder: 6 sites
    full = define_generator("AutoElMarMCDIP22", out_shape=OUT,
                            in_shape=IN[1:])
    assert sum(isinstance(m, blocks.ConvBlock) and m.dropout == 0.1
               for m in full.modules()) == 6


@pytest.fixture(scope="module")
def mc_engine(tmp_path_factory):
    cfg = config.get_workload(
        "mcdip_uq", save_dir=str(tmp_path_factory.mktemp("mc"))).replace(
        **SMALL)
    return ElasticDIPEngine(cfg, device="cpu")


def test_mc_realizations(mc_engine):
    e, w = mc_engine, SMALL["water_rows"]
    a = e.mc_realizations(4, seed=0)
    assert a.shape == (4, SMALL["nz"], SMALL["nx"], 2)
    assert a.dtype == np.float32 and np.isfinite(a).all()
    assert np.array_equal(a, e.mc_realizations(4, seed=0))
    assert not np.array_equal(a, e.mc_realizations(4, seed=1))
    for i in range(4):
        for j in range(i):
            assert not np.array_equal(a[i], a[j])
    std = a.std(0)
    # the pinned water rows are the true model in every sample
    assert np.all(std[:w] == 0.0)
    assert (std[w:] > 0).mean() > 0.99
    # evaluation decodes are deterministic
    assert np.array_equal(e.test()[1], e.test()[1])


def test_mc_masks_are_independent_across_the_batch(mc_engine, monkeypatch):
    e = mc_engine
    masks = []
    monkeypatch.setattr(blocks, "dropout_mask", _recorder(masks))
    batched = e.mc_realizations(5, seed=2)
    assert len(masks) == SITES and all(m.shape[0] == 5 for m in masks)
    for m in masks:
        for i in range(5):
            for j in range(i):
                assert not torch.equal(m[i], m[j])
    kept = torch.stack([m.float().mean() for m in masks])
    assert float((kept - 0.9).abs().max()) < 0.05
    # one batched pass is the samples one at a time with the same masks
    # (GroupNorm is per sample)
    for k in range(5):
        fed = iter([m[k:k + 1] for m in masks])
        monkeypatch.setattr(blocks, "dropout_mask",
                            lambda x, keep, generator, f=fed: next(f))
        with torch.no_grad():
            z = e.net.encode(e.in_vx, e.in_vz)
            one = e._model(e.net.decode(z, deterministic=False,
                                        generator=torch.Generator()))
        assert rel_max(one[0], batched[k]) <= 1e-6


def test_training_decodes_sample_and_others_do_not(tmp_path, monkeypatch):
    cfg = config.get_workload(
        "mcdip_uq_robust", save_dir=str(tmp_path)).replace(
        **SMALL, holdout_every=1)
    e = ElasticDIPEngine(cfg, device="cpu")
    masks = []
    monkeypatch.setattr(blocks, "dropout_mask", _recorder(masks))
    # warmup, then physics with the step cap's two decodes and loss_H
    rec1 = e.optimize_parameters(1)
    assert len(masks) == SITES
    rec2 = e.optimize_parameters(2)
    assert "loss_H" in rec2 and rec1["loss_D_MSE"] == 0.0
    # one training decode each: its masks are new
    assert len(masks) == 2 * SITES
    assert any(not torch.equal(a, b)
               for a, b in zip(masks[:SITES], masks[SITES:]))
    e.test()
    e.holdout_misfit(cfg.freq_stages[0])
    assert len(masks) == 2 * SITES


def test_lbfgs_probes_share_one_mask(tmp_path, monkeypatch):
    cfg = config.get_workload(
        "mcdip_uq", optimizer="lbfgs", save_dir=str(tmp_path)).replace(
        **SMALL)
    e = ElasticDIPEngine(cfg, device="cpu")
    steps = []
    for epoch in (1, 2):
        masks = []
        monkeypatch.setattr(blocks, "dropout_mask", _recorder(masks))
        e.optimize_parameters(epoch)
        # the value and gradient, then each line-search probe
        assert len(masks) == SITES * e.opt.evaluations
        assert e.opt.evaluations >= 2
        for k in range(SITES, len(masks)):
            assert torch.equal(masks[k], masks[k % SITES])
        steps.append(masks[:SITES])
    assert any(not torch.equal(a, b) for a, b in zip(*steps))


def test_dropout_keeps_the_shot_stream(tmp_path):
    """The dropout generator is separate: an engine with dropout draws
    the shots of the same engine without it."""
    kw = dict(SMALL, shots_per_iter=2, lstart=0)
    states = []
    for dropout in (0.1, 0.0):
        cfg = config.get_workload("mcdip_uq", dropout=dropout,
                                  save_dir=str(tmp_path)).replace(**kw)
        e = ElasticDIPEngine(cfg, device="cpu")
        for epoch in (1, 2):
            e.optimize_parameters(epoch)
        states.append(e._shot_gen.get_state())
    assert torch.equal(*states)


def test_acoustic_engine_trains_with_dropout(tmp_path, monkeypatch):
    cfg = config.get_workload(
        "marmousi_acoustic", dropout=0.1, save_dir=str(tmp_path)).replace(
        nz=32, nx=40, nt=200, num_shots=2, num_receivers=8, filters=(4, 8))
    e = AcousticDIPEngine(cfg, device="cpu")
    masks = []
    monkeypatch.setattr(blocks, "dropout_mask", _recorder(masks))
    recs = [e.optimize_parameters(ep) for ep in (1, 2)]
    assert len(masks) == 2  # one up block, one decode a step
    assert not torch.equal(*masks)
    assert all(np.isfinite(r["loss_D"]) for r in recs)
    assert e.test()[0] == e.test()[0] and len(masks) == 2


def test_evaluate_realizations_matches_jax_keys(tmp_path):
    wl = dict(nz=36, nx=48, dx=15.0, nt=64, dt=0.0015, pml_width=8,
              freq=20.0, num_shots=2, num_receivers=10, water_rows=4,
              chunk=16)
    kw = dict(wl, filters=FILTERS, name="mc_eval")
    jwl = JWorkload.build(**wl, seed=0)
    want = j_evaluate(j_config.get_workload("mcdip_uq", **kw),
                      realizations=4, results_dir=str(tmp_path / "jax"),
                      workload=jwl)
    got = evaluate(config.get_workload("mcdip_uq", **kw), realizations=4,
                   results_dir=str(tmp_path / "torch"),
                   workload=port_elastic_workload(jwl), device="cpu")
    assert got.keys() == want.keys() == {"realizations", "mc_std_mean",
                                         "loss_V_MSE"}
    assert got["realizations"] == 4 and got["mc_std_mean"] > 0
    out = tmp_path / "torch" / "mc_eval" / "epoch_latest"
    assert sorted(os.listdir(out)) == sorted(os.listdir(
        tmp_path / "jax" / "mc_eval" / "epoch_latest")) == [
        "mc_mean.npy", "mc_std.npy", "metrics.json"]
    std = np.load(out / "mc_std.npy")
    assert std.shape == np.load(out / "mc_mean.npy").shape == (36, 48, 2)
    assert got["mc_std_mean"] == pytest.approx(float(std.mean()))
    assert json.loads((out / "metrics.json").read_text()) == got


def test_test_cli_realization_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "physicsbasedfwi2_tpu_torch.engine.test",
         "--workload", "mcdip_uq", "--small", "--device", "cpu",
         "--realization", "4", "--save-dir", str(tmp_path / "ck"),
         "--results-dir", str(tmp_path / "res")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(last) == {"realizations", "mc_std_mean", "loss_V_MSE"}
    assert last["realizations"] == 4 and last["mc_std_mean"] > 0
    out = tmp_path / "res" / "mcdip_uq" / "epoch_latest"
    assert np.load(out / "mc_std.npy").shape == (48, 64, 2)
    assert not (out / "model.npy").exists()
