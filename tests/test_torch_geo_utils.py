"""The last geo and utils helpers of the port against the JAX package on
the same numpy inputs: ``geo/units.py``, ``geo/wavelets.py::spike_band``,
the three named acquisitions and ``utils/diagnostics.py``."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu import geo as jgeo
from physicsbasedfwi2_tpu import utils as jutils
from physicsbasedfwi2_tpu_torch import geo, utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("scale", [100.0, 10.0])
def test_units_match_jax(flip, scale):
    m = np.random.default_rng(1).uniform(10, 50, (2, 7, 5)).astype(
        np.float32)
    for fn in ("model_from_storage", "model_to_storage"):
        got = getattr(geo, fn)(torch.tensor(m), scale=scale, flip=flip)
        ref = np.asarray(getattr(jgeo, fn)(jnp.asarray(m), scale=scale,
                                           flip=flip))
        # one float32 multiply or divide each: to the bit
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=fn)
    back = geo.model_from_storage(geo.model_to_storage(m, flip=flip),
                                  flip=flip)
    np.testing.assert_allclose(back.numpy(), m, rtol=1e-6)
    assert geo.STORAGE_SCALE == 100.0


@pytest.mark.parametrize("args", [(2.0, 20.0, 4001, 0.001),
                                  (5.0, 10.0, 300, 0.002),
                                  (1.5, 12.0, 1001, 0.0015)])
def test_spike_band_matches_jax(args):
    from physicsbasedfwi2_tpu.geo.wavelets import spike_band as j_spike
    got = geo.spike_band(*args)
    ref = np.asarray(j_spike(*args))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    # float32 FFTs (pocketfft in both, different plans): 2e-6 of the
    # unit peak
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6)
    assert abs(float(got.abs().max()) - 1.0) < 1e-6


@pytest.mark.parametrize("name,kw", [
    ("marmousi_acoustic_acquisition", {}),
    ("marmousi_acoustic_acquisition", {"nx": 64}),
    ("marmousi_elastic_acquisition", {}),
    ("marmousi_elastic_acquisition", {"nx": 120, "dx": 15.0}),
    ("seam_elastic_acquisition", {}),
    ("seam_elastic_acquisition", {"nx": 97}),
])
def test_named_acquisitions_match_jax(name, kw):
    got, ref = getattr(geo, name)(**kw), getattr(jgeo, name)(**kw)
    for f in ("src_z", "src_x", "rcv_z", "rcv_x"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.num_shots, got.num_receivers) == (ref.num_shots,
                                                  ref.num_receivers)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3,)).astype(np.float32),
            "b": {"c": rng.normal(size=(2, 4)).astype(np.float32),
                  "d": rng.normal(size=(5,)).astype(np.float32)}}


def _as(tree, fn):
    return {k: _as(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def test_diagnostics_match_jax():
    tree = _tree()
    t, j = _as(tree, torch.tensor), _as(tree, jnp.asarray)
    assert utils.is_legal(t) and jutils.is_legal(j)
    bad = _as(tree, torch.tensor)
    bad["b"]["d"][2] = float("nan")
    assert not utils.is_legal(bad)
    assert not utils.is_legal({"x": torch.tensor([np.inf])})
    got, ref = utils.grad_norms(t), jutils.grad_norms(j)
    assert got.keys() == ref.keys() == {"a", "b/c", "b/d"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    flat = np.concatenate([tree["a"], tree["b"]["c"].ravel(),
                           tree["b"]["d"]])
    want = f"[G] mean|x|={np.mean(np.abs(flat)):.3e} params=16 finite=True"
    # one float32 sum a leaf: the same summary line
    assert (utils.diagnose_params(t, "G") == jutils.diagnose_params(j, "G")
            == want)


def test_diagnostics_key_a_net_by_parameter_name():
    net = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 3), torch.nn.GroupNorm(
        1, 3), torch.nn.Linear(4, 2))
    norms = utils.grad_norms(net)
    assert list(norms) == [k for k, _ in net.named_parameters()]
    for k, p in net.named_parameters():
        np.testing.assert_allclose(norms[k], np.linalg.norm(
            p.detach().numpy().ravel()), rtol=1e-6)
    assert utils.grad_norms(net.state_dict()).keys() == norms.keys()
    assert "finite=True" in utils.diagnose_params(net)
    with torch.no_grad():
        net[0].weight[0, 0, 0, 0] = float("nan")
    assert not utils.is_legal(net)
    assert "finite=False" in utils.diagnose_params(net)


def test_geo_utils_landscape_import_no_jax():
    code = ("import sys, physicsbasedfwi2_tpu_torch.landscape.cli, "
            "physicsbasedfwi2_tpu_torch.landscape, "
            "physicsbasedfwi2_tpu_torch.utils, "
            "physicsbasedfwi2_tpu_torch.geo; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'physicsbasedfwi2_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
