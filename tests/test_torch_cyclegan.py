"""CycleGanEngine (engine/cyclegan.py) against the JAX package: one
``optimize_parameters`` step of the JAX test's engine (32 x 32, base 8, 2
resnet blocks) from the JAX weights (G, F, DA, DB carried across) with
both image pools at seed 0: ``loss_G``, ``loss_D``, the weights after the
step and ``translate``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.engine.cyclegan import CycleGanEngine as JEngine
from physicsbasedfwi2_tpu_torch.engine.cyclegan import CycleGanEngine
from physicsbasedfwi2_tpu_torch.models.convert import params_from_flax

from torch_parity import n, t

torch.set_num_threads(1)

NETS = ("G", "F", "DA", "DB")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def step():
    je = JEngine(in_shape=(32, 32), base=8, n_blocks=2)
    pe = CycleGanEngine(in_shape=(32, 32), base=8, n_blocks=2, device="cpu")
    for k in NETS:
        getattr(pe, k).load_state_dict(params_from_flax(_np(je.params[k])))
    rng = np.random.default_rng(0)
    a = rng.uniform(0.1, 1.0, (1, 32, 32, 1)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, (1, 32, 32, 1)).astype(np.float32)
    jrec, prec = je.optimize_parameters(a, b), pe.optimize_parameters(
        t(a), t(b))
    return dict(je=je, pe=pe, a=a, jrec=jrec, prec=prec)


def test_one_step_matches_jax(step):
    jrec, prec = step["jrec"], step["prec"]
    assert jrec.keys() == prec.keys() == {"loss_G", "loss_D"}
    for k in jrec:
        # float32 forward and backward: 1e-5 relative
        np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5, err_msg=k)
    # the weights after one Adam step (lr * sign(gradient) per element):
    # relative L2 1e-4 of the JAX engine's per net (a near-zero gradient
    # may take the other sign, a step of 2 lr apart)
    je, pe = step["je"], step["pe"]
    for k in NETS:
        jp = params_from_flax(_np(je.params[k]))
        sd = getattr(pe, k).state_dict()
        num = sum(float(((sd[q] - jp[q]) ** 2).sum()) for q in sd)
        den = sum(float((v ** 2).sum()) for v in jp.values())
        assert (num / den) ** 0.5 <= 1e-4, k
    # the pools hold this step's fakes, as torch tensors
    assert len(pe.pool_A.images) == len(je.pool_A.images) == 1
    ref = je.pool_B.images[0]
    # a float32 forward: 1e-5 of max
    np.testing.assert_allclose(n(pe.pool_B.images[0]), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_translate_matches_jax(step):
    ref = np.asarray(step["je"].translate(jnp.asarray(step["a"])))
    got = step["pe"].translate(t(step["a"]))
    assert got.shape == ref.shape == (1, 32, 32, 1)
    assert not got.requires_grad
    np.testing.assert_allclose(n(got), ref, rtol=0, atol=1e-4)


def test_seeded_init_and_device():
    a = CycleGanEngine(base=8, n_blocks=1, device="cpu", seed=3)
    b = CycleGanEngine(base=8, n_blocks=1, device="cpu", seed=3)
    for k in NETS:
        for q, v in getattr(a, k).state_dict().items():
            assert torch.equal(v, getattr(b, k).state_dict()[q]), (k, q)
    assert not torch.equal(a.G.convs[0].weight, a.F.convs[0].weight)
    assert a.DA.convs[0].in_channels == 1 and len(a.DA.norms) == 2
    assert a.device.type == "cpu"


def test_no_card_no_quiet_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        CycleGanEngine(base=8, n_blocks=1)
