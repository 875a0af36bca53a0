"""Kernel B1 (forward2): the port's plain version against the Pallas
kernel in interpret mode, as tests/test_golden.py runs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.geo import ricker as j_ricker
from physicsbasedfwi2_tpu.ops.pallas_scalar2 import forward2 as j_forward2
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    _lap, forward2, forward2_plain,
)

from torch_parity import (
    acoustic_case, jax_acoustic, n, rel_max, t, torch_acoustic,
)

torch.set_num_threads(1)


def _case(free_surface=False, per_shot_wavelet=False):
    grid, cfg, wargs, vp, geom = acoustic_case()
    grid = dict(grid, free_surface=free_surface)
    rng = np.random.default_rng(5)
    vp = vp + rng.uniform(-50, 50, vp.shape).astype(np.float32)
    wav = np.asarray(j_ricker(*wargs))
    if per_shot_wavelet:
        wav = np.stack([wav, 0.5 * np.roll(wav, 7)]).astype(np.float32)
    return grid, cfg, wav, vp, geom


@pytest.mark.parametrize("return_rows", [False, True])
@pytest.mark.parametrize("free_surface,per_shot",
                         [(False, False), (True, True)])
def test_forward2_matches_pallas_interpret(return_rows, free_surface,
                                           per_shot):
    grid, cfg, wav, vp, geom = _case(free_surface, per_shot)
    ref = j_forward2(jnp.asarray(vp), jnp.asarray(wav),
                     *map(jnp.asarray, geom), jax_acoustic(grid, cfg),
                     return_rows=return_rows, interpret=True)
    got = forward2(t(vp), t(wav), *map(t, geom), torch_acoustic(grid, cfg),
                   return_rows=return_rows)
    assert got.shape == ref.shape
    # the same float32 operations in the same order; only the runtime's
    # rounding of 180 steps differs: 1e-5 of max
    assert rel_max(got, ref) <= 1e-5


def test_forward2_cpu_takes_plain_version_without_launching():
    grid, cfg, wav, vp, geom = _case()
    before = forward2.launches
    a = forward2(t(vp), t(wav), *map(t, geom), torch_acoustic(grid, cfg))
    b = forward2_plain(t(vp), t(wav), *map(t, geom),
                       torch_acoustic(grid, cfg))
    assert forward2.launches == before
    np.testing.assert_array_equal(n(a), n(b))


def test_forward2_float64_reference_is_close():
    grid, cfg, wav, vp, geom = _case()
    tc = torch_acoustic(grid, cfg)
    a = forward2_plain(t(vp), t(wav), *map(t, geom), tc)
    b = forward2_plain(t(vp), t(wav), *map(t, geom), tc,
                       dtype=torch.float64)
    assert b.dtype == torch.float64
    # float32 rounding over 180 steps
    assert rel_max(a, b) <= 1e-5


def test_forward2_other_devices_raise():
    grid, cfg, wav, vp, geom = _case()
    with pytest.raises(ValueError, match="no kernel"):
        forward2(t(vp).to("meta"), t(wav), *map(t, geom),
                 torch_acoustic(grid, cfg))


def test_lap_reads_zeros_outside_like_a_roll_over_a_zero_ring():
    # Pallas rolls circularly; on a field that is zero within 2 cells of
    # the edge the two Laplacians agree exactly
    rng = np.random.default_rng(6)
    f = np.zeros((3, 16, 24), np.float32)
    f[:, 2:-2, 2:-2] = rng.standard_normal((3, 12, 20))
    from physicsbasedfwi2_tpu.ops.pallas_scalar2 import _L0, _L1, _L2

    def roll_lap(x):
        r = lambda k, ax: np.roll(x, -k, axis=ax)  # noqa: E731
        return (np.float32(2.0 * _L0) * x
                + np.float32(_L1) * (r(1, 2) + r(-1, 2) + r(1, 1) + r(-1, 1))
                + np.float32(_L2) * (r(2, 2) + r(-2, 2) + r(2, 1)
                                     + r(-2, 1)))

    np.testing.assert_array_equal(n(_lap(t(f))), roll_lap(f))
