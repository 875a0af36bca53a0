"""The generators' bilinear resizes with a deterministic backward
(``models/blocks.py``: ``resize_2x`` and ``fit_to_shape``): the forward
is ``F.interpolate`` bit for bit, the backward (slices and adds for the
2x upsample, the separable weight matrices for the general enlargement)
agrees with ``F.interpolate``'s autograd and with ``jax.vjp`` of
``jax.image.resize``, and passes ``gradcheck`` in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from physicsbasedfwi2_tpu_torch.models.blocks import (
    fit_to_shape, resize_2x, upsample_weights,
)

from torch_parity import n, rel_max, t

torch.set_num_threads(1)

# NCHW inputs: odd and even sizes, a single row and a single column
SHAPES = [(2, 3, 5, 7), (1, 4, 8, 6), (1, 2, 1, 9), (2, 1, 6, 1)]
# (input shape, fit_to_shape's out_shape): both axes enlarged, one
# enlarged and one cropped, one kept, and the Auto decoders' sizes
FITS = [((2, 3, 5, 7), (11, 13)), ((1, 2, 6, 9), (14, 5)),
        ((1, 2, 6, 9), (6, 20)), ((1, 4, 20, 25), (151, 200))]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((shape[0], shape[1], 2 * shape[2],
                                 2 * shape[3])).astype(np.float32))


def _torch_vjp(fn, x, g):
    xt = t(x).requires_grad_()
    out = fn(xt)
    (gx,) = torch.autograd.grad(out, xt, t(g))
    return out.detach(), gx


def _jax_vjp(x, size, g):
    out, vjp = jax.vjp(lambda a: jax.image.resize(
        a, a.shape[:2] + tuple(size), "bilinear"), jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("shape", SHAPES)
def test_resize_2x_forward_is_interpolate(shape):
    x, _ = _inputs(shape, 0)
    ref = F.interpolate(t(x), scale_factor=2, mode="bilinear",
                        align_corners=False)
    assert torch.equal(resize_2x(t(x)), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_resize_2x_backward_matches_autograd_and_jax(shape):
    x, g = _inputs(shape, 1)
    out, gx = _torch_vjp(resize_2x, x, g)
    _, ref = _torch_vjp(lambda a: F.interpolate(
        a, scale_factor=2, mode="bilinear", align_corners=False), x, g)
    j_out, j_gx = _jax_vjp(x, (2 * shape[2], 2 * shape[3]), g)
    assert rel_max(gx, ref) <= 1e-6
    assert rel_max(gx, j_gx) <= 1e-6
    assert rel_max(out, j_out) <= 1e-6


def _fit_reference(x, out_shape):
    h, w = x.shape[2:]
    size = (max(h, out_shape[0]), max(w, out_shape[1]))
    if size != (h, w):
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=False)
    return x[:, :, :out_shape[0], :out_shape[1]]


@pytest.mark.parametrize("shape,out_shape", FITS)
def test_fit_to_shape_forward_is_interpolate(shape, out_shape):
    x, _ = _inputs(shape, 2)
    assert torch.equal(fit_to_shape(t(x), out_shape),
                       _fit_reference(t(x), out_shape))


@pytest.mark.parametrize("shape,out_shape", FITS)
def test_fit_to_shape_backward_matches_autograd_and_jax(shape, out_shape):
    x = _inputs(shape, 3)[0]
    size = (max(shape[2], out_shape[0]), max(shape[3], out_shape[1]))
    g = np.random.default_rng(4).standard_normal(
        shape[:2] + tuple(out_shape)).astype(np.float32)
    _, gx = _torch_vjp(lambda a: fit_to_shape(a, out_shape), x, g)
    # F.interpolate's autograd in float64: its float32 one sums in float32
    # (1.1e-6 of max from float64 at 20 x 25 -> 151 x 200; the port's
    # float64 matmuls ~3e-8)
    _, ref = _torch_vjp(lambda a: _fit_reference(a, out_shape),
                        x.astype(np.float64), g.astype(np.float64))
    # JAX: the resize's cotangent is g zero-padded to the resized shape
    g_full = np.zeros(shape[:2] + size, np.float32)
    g_full[:, :, :out_shape[0], :out_shape[1]] = g
    _, j_gx = _jax_vjp(x, size, g_full)
    assert rel_max(gx, ref) <= 1e-6
    assert rel_max(gx, j_gx) <= 1e-6


@pytest.mark.parametrize("n_in,n_out", [(5, 11), (7, 7), (1, 4), (20, 151)])
def test_upsample_weights_are_interpolates(n_in, n_out):
    eye = torch.eye(n_in, dtype=torch.float64)[None, None]  # [1,1,n_in,n_in]
    ref = F.interpolate(eye, size=(n_out, n_in), mode="bilinear",
                        align_corners=False)[0, 0]
    np.testing.assert_allclose(n(upsample_weights(n_in, n_out,
                                                  torch.float64)),
                               n(ref), rtol=0, atol=1e-12)


def test_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 2, 4, 5, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    assert torch.autograd.gradcheck(resize_2x, (x,))
    assert torch.autograd.gradcheck(lambda a: fit_to_shape(a, (9, 11)), (x,))
    assert torch.autograd.gradcheck(lambda a: fit_to_shape(a, (3, 12)), (x,))
