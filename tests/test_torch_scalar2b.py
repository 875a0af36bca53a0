"""Kernels B7a and B7b and ``acoustic_pallas2b``: the port's plain
versions (CPU tensors) against the JAX package's Pallas kernels in
interpret mode, at an even (2) and an odd (3, padded to 4) shot count,
and against the port's plain B4a/B4b.

Tolerances are those of tests/test_torch_acoustic_pallas.py: the two
sides run the same float32 operations in the same order, so traces and
checkpoints agree to 1e-5 of their max and gradients to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.ops import pallas_scalar2b as j_s2b
from physicsbasedfwi2_tpu_torch.ops import scalar2, scalar2b

from test_torch_acoustic_pallas import CFG, GRID, _case, interpret_mode
from torch_parity import jax_acoustic, n, rel_max, t, torch_acoustic

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[2, 3], ids=["ns2", "ns3"])
def runs(request):
    """Each JAX Pallas kernel once per shot count, in interpret mode."""
    ns = request.param
    vp, obs_vp, wav, geom = _case(ns=ns)
    jg = tuple(map(jnp.asarray, geom))
    jc = jax_acoustic(GRID, CFG)
    rows = np.random.default_rng(13).standard_normal(
        (ns, 64, 128)).astype(np.float32)
    out = dict(ns=ns, vp=vp, wav=wav, geom=geom, rows=rows)
    with interpret_mode():
        recs, ckpt = j_s2b.forward2b(jnp.asarray(vp), jnp.asarray(wav), *jg,
                                     jc)
        out["recs"], out["ckpt"] = np.asarray(recs), np.asarray(ckpt)
        obs = j_s2b.forward2b(jnp.asarray(obs_vp), jnp.asarray(wav), *jg,
                              jc)[0]
        out["obs"] = np.asarray(obs)

        def loss(v, w):
            return jnp.mean((j_s2b.acoustic_pallas2b(v, w, *jg, jc) - obs)
                            ** 2)

        gv, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(vp),
                                                jnp.asarray(wav))
        out["grad"], out["wav_grad"] = np.asarray(gv), np.asarray(gw)
        out["bwd"] = np.asarray(j_s2b._backward2b(
            jnp.asarray(vp), jnp.asarray(wav), *jg, jc, jnp.asarray(rows),
            ckpt))
    return out


def _port(runs):
    return (t(runs["vp"]), t(runs["wav"]), tuple(map(t, runs["geom"])),
            torch_acoustic(GRID, CFG))


def test_b7a_traces_and_checkpoints_match_pallas_interpret(runs):
    vp, wav, geom, cfg = _port(runs)
    before = scalar2b.forward2b.launches
    recs, ckpt = scalar2b.forward2b(vp, wav, *geom, cfg)
    assert scalar2b.forward2b.launches == before  # CPU: the plain version
    assert recs.shape == runs["recs"].shape == (runs["ns"], 64, 6)
    # shots padded to pairs, KC = 16: [ns_p/2, n_ck, 2, B, nz8, nx128]
    assert ckpt.shape == runs["ckpt"].shape == (-(-runs["ns"] // 2), 4, 2,
                                                2, 40, 128)
    assert rel_max(recs, runs["recs"]) <= 1e-5
    assert rel_max(ckpt, runs["ckpt"]) <= 1e-5


def test_b7b_gradient_and_zero_wavelet_gradient_match_pallas_interpret(runs):
    vp, wav, geom, cfg = _port(runs)
    v = vp.clone().requires_grad_(True)
    w = wav.clone().requires_grad_(True)
    loss = torch.mean((scalar2b.acoustic_pallas2b(v, w, *geom, cfg)
                       - t(runs["obs"])) ** 2)
    loss.backward()
    assert rel_max(v.grad, runs["grad"]) <= 1e-4
    assert np.all(runs["wav_grad"] == 0.0)
    assert torch.equal(w.grad, torch.zeros_like(wav))


def test_b7b_backward_of_given_rows_matches_pallas_interpret(runs):
    vp, wav, geom, cfg = _port(runs)
    _, ckpt = scalar2b.forward2b(vp, wav, *geom, cfg)
    before = scalar2b.backward2b.launches
    got = scalar2b.backward2b(vp, wav, *geom, cfg, t(runs["rows"]), ckpt)
    assert scalar2b.backward2b.launches == before
    assert rel_max(got, runs["bwd"]) <= 1e-4


def test_plain_b7_equals_plain_b4(runs):
    """One scheme in two layouts: B7a's traces and checkpoints are B4a's
    (at the same KC), and B7b's gradient is B4b's (the padded shot gets
    zero rows, so its dJ/dK is exactly 0 and the pair order of the sum
    adds nothing at two pairs or fewer)."""
    vp, wav, geom, cfg = _port(runs)
    ns = runs["ns"]
    recs, ckpt = scalar2b.forward2b_plain(vp, wav, *geom, cfg)
    recs4, ckpt4 = scalar2.forward2_ckpt_plain(vp, wav, *geom, cfg, KC=16)
    np.testing.assert_array_equal(n(recs), n(recs4))
    # the padded shot repeats the last one
    padded = torch.cat([ckpt4, ckpt4[-1:]]) if ns % 2 else ckpt4
    np.testing.assert_array_equal(n(scalar2b._from_pairs(ckpt)), n(padded))
    rows = t(runs["rows"])
    np.testing.assert_array_equal(
        n(scalar2b.backward2b_plain(vp, wav, *geom, cfg, rows, ckpt)),
        n(scalar2.backward2_plain(vp, wav, *geom, cfg, rows, ckpt4)))


def test_pad_shots_repeats_the_last_shot():
    a = torch.arange(6).reshape(3, 2)
    (p,), ns_p = scalar2b._pad_shots([a], 3)
    assert ns_p == 4
    np.testing.assert_array_equal(n(p), [[0, 1], [2, 3], [4, 5], [4, 5]])
    (q,), ns_q = scalar2b._pad_shots([a[:2]], 2)
    assert ns_q == 2 and torch.equal(q, a[:2])


def test_backward2b_float64_plain_and_other_devices():
    vp, _, wav, geom = _case(ns=2)
    cfg = torch_acoustic(GRID, CFG)
    geom = tuple(map(t, geom))
    _, ckpt = scalar2b.forward2b_plain(t(vp), t(wav), *geom, cfg)
    rows = t(np.random.default_rng(14).standard_normal(
        (2, 64, 128)).astype(np.float32))
    g32 = scalar2b.backward2b_plain(t(vp), t(wav), *geom, cfg, rows, ckpt)
    g64 = scalar2b.backward2b_plain(t(vp), t(wav), *geom, cfg, rows, ckpt,
                                    dtype=torch.float64)
    assert g64.dtype == torch.float64
    # the same discrete problem without float32 rounding
    assert rel_max(g32, g64) <= 1e-4
    for fn in (scalar2b.forward2b, scalar2b.acoustic_pallas2b):
        with pytest.raises(ValueError, match="no kernel"):
            fn(t(vp).to("meta"), t(wav), *geom, cfg)
