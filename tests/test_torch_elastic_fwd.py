"""Kernel B8 (``elastic_forward_pallas``): the port's plain version (CPU
tensors) against the JAX package's Pallas kernel in interpret mode and
against the port's ring forward, on the fused-elastic test case with an
absorbing top; and the free-surface refusal of both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.geo import ricker as j_ricker
from physicsbasedfwi2_tpu.ops import pallas_elastic as j_el
from physicsbasedfwi2_tpu_torch.ops import elastic_fused, elastic_fwd

from test_torch_acoustic_pallas import interpret_mode
from torch_parity import (
    elastic_case, jax_elastic, n, rel_max, t, torch_elastic,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    grid, cfg, wargs, med, geom = elastic_case(free_surface=False)
    wav = np.asarray(j_ricker(*wargs))
    with interpret_mode():
        ref = j_el.elastic_forward_pallas(
            *map(jnp.asarray, med), jnp.asarray(wav),
            *map(jnp.asarray, geom), jax_elastic(grid, cfg))
    return dict(grid=grid, cfg=cfg, wav=wav, med=med, geom=geom,
                ref=tuple(np.asarray(a) for a in ref))


def _run(fn, c, **grid_kw):
    cfg = torch_elastic(dict(c["grid"], **grid_kw), c["cfg"])
    return fn(*map(t, c["med"]), t(c["wav"]), *map(t, c["geom"]), cfg)


def test_b8_matches_pallas_interpret(case):
    before = elastic_fwd.elastic_forward_pallas.launches
    got = _run(elastic_fwd.elastic_forward_pallas, case)
    assert elastic_fwd.elastic_forward_pallas.launches == before  # plain
    for a, b in zip(got, case["ref"]):
        assert a.shape == b.shape == (2, 64, 10)
        # the same float32 operations in the same order over 64 steps
        assert rel_max(a, b) <= 1e-5


def test_b8_is_the_ring_forward_without_free_surface(case):
    got = _run(elastic_fwd.elastic_forward_pallas, case)
    ring = _run(elastic_fused.simulate_elastic_ring, case)
    for a, b in zip(got, ring):
        # _prepare_el and prep_medium / prep_damp build the same media
        # and sponge; only the source gain's constant is formed in
        # another order (dt (1/dx)^2 against dt/dx^2)
        assert rel_max(a, b) <= 1e-6
    meds, damp, _ = elastic_fwd._prepare_el(
        *map(t, case["med"]), torch_elastic(case["grid"], case["cfg"]))
    cfg = torch_elastic(case["grid"], case["cfg"])
    for a, b in zip(meds, elastic_fused.prep_medium(*map(t, case["med"]),
                                                    cfg)):
        np.testing.assert_array_equal(n(a), n(b))
    np.testing.assert_array_equal(n(damp), n(elastic_fused.prep_damp(cfg)))


def test_free_surface_raises_in_both_packages(case):
    with pytest.raises(NotImplementedError, match="absorbing tops"):
        _run(elastic_fwd.elastic_forward_pallas, case, free_surface=True)
    with pytest.raises(NotImplementedError, match="absorbing tops"):
        j_el.elastic_forward_pallas(
            *map(jnp.asarray, case["med"]), jnp.asarray(case["wav"]),
            *map(jnp.asarray, case["geom"]),
            jax_elastic(dict(case["grid"], free_surface=True), case["cfg"]))


def test_b8_other_devices_raise(case):
    cfg = torch_elastic(case["grid"], case["cfg"])
    with pytest.raises(ValueError, match="no kernel"):
        elastic_fwd.elastic_forward_pallas(
            *(t(a).to("meta") for a in case["med"]), t(case["wav"]),
            *map(t, case["geom"]), cfg)
