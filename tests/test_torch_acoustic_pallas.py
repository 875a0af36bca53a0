"""Kernels B4a, B4b, B5 and B6, the differentiable propagators
``acoustic_pallas2`` and ``acoustic_pallas``, ``select_acoustic`` and
``build(backend="pallas")``: the port's plain versions (CPU tensors)
against the JAX package's Pallas kernels in interpret mode.

``forward2_ckpt``, ``_backward2``, ``acoustic_forward_pallas`` and
``_pallas_backward`` take no ``interpret`` argument, so the JAX side
runs with ``pl.pallas_call`` wrapped to add ``interpret=True``.

Tolerances: the two sides run the same float32 operations in the same
order (only the runtime's rounding differs), so traces and checkpoints
agree to 1e-5 of their max and gradients to 1e-4.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from physicsbasedfwi2_tpu.geo import ricker as j_ricker
from physicsbasedfwi2_tpu.ops import pallas_adjoint as j_adj
from physicsbasedfwi2_tpu.ops import pallas_kernels as j_kern
from physicsbasedfwi2_tpu.ops import pallas_scalar2 as j_s2
from physicsbasedfwi2_tpu_torch import ops
from physicsbasedfwi2_tpu_torch.ops import adjoint, kernels, scalar2

from torch_parity import jax_acoustic, n, rel_max, t, torch_acoustic

torch.set_num_threads(1)

_ORIG_PALLAS_CALL = pl.pallas_call


@contextlib.contextmanager
def interpret_mode():
    """Every ``pl.pallas_call`` in interpret mode (an explicit
    ``interpret=`` is overridden)."""
    def call(*a, **k):
        return _ORIG_PALLAS_CALL(*a, **{**k, "interpret": True})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", call)
        yield


GRID = dict(nz=24, nx=32, dx=10.0, nt=64, dt=0.001, pml_width=8)
CFG = dict(chunk=16, vmax_pml=3000.0)


def _case(ns=2, nr=6, rcv_rows=(3,)):
    rng = np.random.default_rng(11)
    vp = (2000.0 + 300.0 * rng.standard_normal((24, 32))).astype(np.float32)
    vp[:4] = 1500.0
    wav = np.asarray(j_ricker(25.0, GRID["nt"], GRID["dt"]))
    src_z = np.full(ns, 2, np.int32)
    src_x = np.linspace(4, 27, ns).astype(np.int32)
    rcv_z = np.tile(np.resize(np.asarray(rcv_rows, np.int32), nr), (ns, 1))
    rcv_x = np.tile(np.linspace(1, 30, nr).astype(np.int32), (ns, 1))
    obs_vp = vp * np.float32(1.05)
    return vp, obs_vp, wav, (src_z, src_x, rcv_z, rcv_x)


def _jax_l2_grad(prop, vp, obs, wav, geom, cfg):
    def loss(v):
        return jnp.mean((prop(v, jnp.asarray(wav), *map(jnp.asarray, geom),
                              cfg) - obs) ** 2)
    return jax.grad(loss, argnums=0)(jnp.asarray(vp))


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX Pallas kernel once, in interpret mode."""
    vp, obs_vp, wav, geom = _case()
    jg = tuple(map(jnp.asarray, geom))
    jc = jax_acoustic(GRID, CFG)
    rng = np.random.default_rng(12)
    out = {}
    with interpret_mode():
        out["b5"] = np.asarray(j_kern.acoustic_forward_pallas(
            jnp.asarray(vp), jnp.asarray(wav), *jg, jc))
        obs5 = j_kern.acoustic_forward_pallas(jnp.asarray(obs_vp),
                                              jnp.asarray(wav), *jg, jc)
        out["obs5"] = np.asarray(obs5)
        out["grad6"] = np.asarray(_jax_l2_grad(
            j_adj.acoustic_pallas, vp, obs5, wav, geom, jc))
        out["wav_grad6"] = np.asarray(jax.grad(lambda w: jnp.sum(
            j_adj.acoustic_pallas(jnp.asarray(vp), w, *jg, jc)))(
                jnp.asarray(wav)))
        rows6 = rng.standard_normal((2, 64, 128)).astype(np.float32)
        rows6[:, :, :8] = 0.0  # only columns a receiver could sit on
        out["rows6"] = rows6
        out["bwd6"] = np.asarray(j_adj._pallas_backward(
            jnp.asarray(vp), jnp.asarray(wav), *jg, jc, jnp.asarray(rows6)))
        recs, ckpt = j_s2.forward2_ckpt(jnp.asarray(vp), jnp.asarray(wav),
                                        *jg, jc)
        out["b4a"], out["ckpt"] = np.asarray(recs), np.asarray(ckpt)
        obs4 = j_s2.forward2(jnp.asarray(obs_vp), jnp.asarray(wav), *jg, jc)
        out["obs4"] = np.asarray(obs4)
        out["grad4"] = np.asarray(_jax_l2_grad(
            j_s2.acoustic_pallas2, vp, obs4, wav, geom, jc))
        out["wav_grad4"] = np.asarray(jax.grad(lambda w: jnp.sum(
            j_s2.acoustic_pallas2(jnp.asarray(vp), w, *jg, jc)))(
                jnp.asarray(wav)))
        rows4 = rng.standard_normal((2, 64, 128)).astype(np.float32)
        out["rows4"] = rows4
        out["bwd4"] = np.asarray(j_s2._backward2(
            jnp.asarray(vp), jnp.asarray(wav), *jg, jc, jnp.asarray(rows4),
            ckpt))
    return out


@pytest.fixture(scope="module")
def case():
    vp, obs_vp, wav, geom = _case()
    return t(vp), t(wav), tuple(map(t, geom)), torch_acoustic(GRID, CFG)


def _l2_grad(prop, case, obs):
    vp, wav, geom, cfg = case
    v = vp.clone().requires_grad_(True)
    loss = torch.mean((prop(v, wav, *geom, cfg) - t(obs)) ** 2)
    (g,) = torch.autograd.grad(loss, v)
    return g


# ---------------------------------------------------------------------------
# B5 and B6
# ---------------------------------------------------------------------------

def test_b5_forward_matches_pallas_interpret(jax_runs, case):
    vp, wav, geom, cfg = case
    before = kernels.acoustic_forward_pallas.launches
    got = kernels.acoustic_forward_pallas(vp, wav, *geom, cfg)
    assert kernels.acoustic_forward_pallas.launches == before  # CPU: plain
    assert got.shape == jax_runs["b5"].shape
    assert rel_max(got, jax_runs["b5"]) <= 1e-5


def test_b5_is_close_to_simulate_acoustic(case):
    # the same scheme up to the ring and the association of 1/dx: the
    # bound tpu_tests/test_pallas_tpu.py uses on the TPU
    vp, wav, geom, cfg = case
    got = kernels.acoustic_forward_pallas(vp, wav, *geom, cfg)
    ref = ops.simulate_acoustic(vp, wav, *geom, cfg)
    assert rel_max(got, ref) <= 5e-3


def test_b6_gradient_matches_pallas_interpret(jax_runs, case):
    g = _l2_grad(adjoint.acoustic_pallas, case, jax_runs["obs5"])
    assert rel_max(g, jax_runs["grad6"]) <= 1e-4


def test_b6_backward_of_given_rows_matches_pallas_interpret(jax_runs, case):
    vp, wav, geom, cfg = case
    before = adjoint.acoustic_pallas_backward.launches
    got = adjoint.acoustic_pallas_backward(vp, wav, *geom, cfg,
                                           t(jax_runs["rows6"]))
    assert adjoint.acoustic_pallas_backward.launches == before
    assert rel_max(got, jax_runs["bwd6"]) <= 1e-4


# ---------------------------------------------------------------------------
# B4a and B4b
# ---------------------------------------------------------------------------

def test_b4a_traces_and_checkpoints_match_pallas_interpret(jax_runs, case):
    vp, wav, geom, cfg = case
    before = scalar2.forward2_ckpt.launches
    recs, ckpt = scalar2.forward2_ckpt(vp, wav, *geom, cfg)
    assert scalar2.forward2_ckpt.launches == before
    assert recs.shape == jax_runs["b4a"].shape
    assert ckpt.shape == jax_runs["ckpt"].shape == (2, 2, 2, 40, 128)
    assert rel_max(recs, jax_runs["b4a"]) <= 1e-5
    assert rel_max(ckpt, jax_runs["ckpt"]) <= 1e-5
    # B4a's traces are B1's (one step kernel)
    np.testing.assert_array_equal(
        n(recs), n(scalar2.forward2(vp, wav, *geom, cfg)))


def test_b4b_gradient_matches_pallas_interpret(jax_runs, case):
    g = _l2_grad(scalar2.acoustic_pallas2, case, jax_runs["obs4"])
    assert rel_max(g, jax_runs["grad4"]) <= 1e-4


def test_b4b_backward_of_given_rows_matches_pallas_interpret(jax_runs, case):
    vp, wav, geom, cfg = case
    _, ckpt = scalar2.forward2_ckpt(vp, wav, *geom, cfg)
    before = scalar2.backward2.launches
    got = scalar2.backward2(vp, wav, *geom, cfg, t(jax_runs["rows4"]), ckpt)
    assert scalar2.backward2.launches == before
    assert rel_max(got, jax_runs["bwd4"]) <= 1e-4


# ---------------------------------------------------------------------------
# the autograd Functions' contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prop,key", [("acoustic_pallas", "wav_grad6"),
                                      ("acoustic_pallas2", "wav_grad4")])
def test_wavelet_cotangent_is_zero(jax_runs, case, prop, key):
    vp, wav, geom, cfg = case
    fn = (adjoint.acoustic_pallas if prop == "acoustic_pallas"
          else scalar2.acoustic_pallas2)
    v = vp.clone().requires_grad_(True)
    w = wav.clone().requires_grad_(True)
    fn(v, w, *geom, cfg).sum().backward()
    assert np.all(jax_runs[key] == 0.0)
    assert torch.equal(w.grad, torch.zeros_like(wav))
    assert v.grad is not None and bool(torch.any(v.grad != 0))


@pytest.mark.parametrize("prop", ["b5", "b4"])
def test_only_the_first_receiver_row_is_recorded(prop):
    """Both Pallas propagators record row rcv_z[:, 0] for every receiver
    of a shot; the port matches, silently, as they do."""
    vp, _, wav, geom = _case(rcv_rows=(3, 9))
    flat = (geom[0], geom[1], np.repeat(geom[2][:, :1], 6, axis=1), geom[3])
    jc, cfg = jax_acoustic(GRID, CFG), torch_acoustic(GRID, CFG)
    jfn, tfn = ((j_kern.acoustic_forward_pallas,
                 kernels.acoustic_forward_pallas) if prop == "b5"
                else (j_s2.forward2, scalar2.forward2))
    with interpret_mode():
        ref = np.asarray(jfn(jnp.asarray(vp), jnp.asarray(wav),
                             *map(jnp.asarray, geom), jc))
    got = tfn(t(vp), t(wav), *map(t, geom), cfg)
    np.testing.assert_array_equal(
        n(got), n(tfn(t(vp), t(wav), *map(t, flat), cfg)))
    assert rel_max(got, ref) <= 1e-5


def test_select_acoustic_maps_backends(monkeypatch):
    assert ops.select_acoustic("xla") is ops.simulate_acoustic
    assert ops.select_acoustic("pallas") is ops.acoustic_pallas
    assert ops.acoustic_pallas is adjoint.acoustic_pallas
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ops.select_acoustic("auto") is ops.simulate_acoustic
    assert ops.select_acoustic() is ops.simulate_acoustic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ops.select_acoustic("auto") is ops.acoustic_pallas


@pytest.mark.parametrize("fn", [kernels.acoustic_forward_pallas,
                                scalar2.forward2_ckpt])
def test_other_devices_raise(case, fn):
    vp, wav, geom, cfg = case
    with pytest.raises(ValueError, match="no kernel"):
        fn(vp.to("meta"), wav, *geom, cfg)


def test_build_pallas_backend_matches_jax():
    from physicsbasedfwi2_tpu.data.synthetic import (
        SyntheticAcousticWorkload as JWL)
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        SyntheticAcousticWorkload)
    kw = dict(nz=30, nx=28, dx=10.0, nt=60, dt=0.001, freq=20.0,
              pml_width=8, num_shots=2, num_receivers=5, seed=3,
              water_rows=4, backend="pallas")
    with interpret_mode():
        a = JWL.build(**kw)
    before = kernels.acoustic_forward_pallas.launches
    b = SyntheticAcousticWorkload.build(**kw, device="cpu")
    assert kernels.acoustic_forward_pallas.launches == before
    np.testing.assert_array_equal(n(b.vp_true), np.asarray(a.vp_true))
    assert rel_max(b.obs, a.obs) <= 1e-5
    assert rel_max(b.obs_norm, a.obs_norm) <= 1e-5
