"""The GAN pieces (models/gan.py) against the JAX package: ResnetGenerator,
NLayerDiscriminator (2 and 3 layers) and PixelDiscriminator with the Flax
weights carried across, forward and the input and weight VJPs, on an even
(32 x 32) and an odd (33 x 31) image, so that Flax's SAME padding of the
strided and 4x4 convs is held in both parities; the converter both ways;
``gan_loss`` in its three modes; ``gradient_penalty`` with JAX's mixing
weights handed to the port; ``ImagePool``'s draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.models import gan as jgan
from physicsbasedfwi2_tpu_torch.models import (
    ImagePool, NLayerDiscriminator, PixelDiscriminator, ResnetGenerator,
    define_discriminator, gan_loss, gradient_penalty,
)
from physicsbasedfwi2_tpu_torch.models import gan
from physicsbasedfwi2_tpu_torch.models.blocks import (
    SameConv2d, same_padding,
)
from physicsbasedfwi2_tpu_torch.models.convert import (
    npz_from_state_dict, params_from_flax, params_to_flax,
    state_dict_from_npz,
)

from torch_parity import n, t

torch.set_num_threads(1)

BASE = 8
# case -> (Flax module, port class, port kwargs, input channels)
NETS = {
    "resnet": (jgan.ResnetGenerator(out_channels=1, base=BASE, n_blocks=2),
               ResnetGenerator, dict(base=BASE, n_blocks=2), 1),
    "nlayer2": (jgan.NLayerDiscriminator(base=BASE, n_layers=2),
                NLayerDiscriminator, dict(base=BASE, n_layers=2), 2),
    "nlayer3": (jgan.NLayerDiscriminator(base=BASE, n_layers=3),
                NLayerDiscriminator, dict(base=BASE, n_layers=3), 2),
    "pixel": (jgan.PixelDiscriminator(base=BASE), PixelDiscriminator,
              dict(base=BASE), 2),
}
SIZES = {"even": (32, 32), "odd": (33, 31)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=[(k, s) for k in sorted(NETS)
                                        for s in sorted(SIZES)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    name, size = request.param
    jnet, cls, kw, cin = NETS[name]
    x = np.random.default_rng(0).standard_normal(
        (2, *SIZES[size], cin)).astype(np.float32)
    params = _np(jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    net = cls(in_channels=cin, **kw)
    net.load_state_dict(params_from_flax(params))
    return dict(jnet=jnet, params=params, net=net, x=x)


def test_forward_matches_flax(case):
    ref = np.asarray(jax.jit(case["jnet"].apply)(case["params"],
                                                 jnp.asarray(case["x"])))
    with torch.no_grad():
        got = n(case["net"](t(case["x"])))
    assert got.shape == ref.shape
    # float32 convolutions and GroupNorm statistics summed in another
    # order: 1e-5 of max
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_vjp_matches_flax(case):
    jnet, params, x = case["jnet"], case["params"], jnp.asarray(case["x"])
    w = np.random.default_rng(1).standard_normal(
        jnet.apply(params, x).shape).astype(np.float32)

    def scalar(p, xx):
        return jnp.sum(jnet.apply(p, xx) * w)

    jgp, jgx = _np(jax.jit(jax.grad(scalar, argnums=(0, 1)))(params, x))
    jg = params_from_flax(jgp)
    net = case["net"]
    net.zero_grad()
    xt = t(case["x"]).requires_grad_(True)
    torch.sum(net(xt) * t(w)).backward()
    # input gradient: 1e-5 of max; weights: 1e-5 of the largest entry
    # (conv biases in front of a GroupNorm have a zero gradient, which
    # both frameworks return as rounding noise), 1e-4 relative
    np.testing.assert_allclose(n(xt.grad), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5 * float(np.abs(jgx).max()))
    scale = max(float(g.abs().max()) for g in jg.values())
    assert jg.keys() == dict(net.named_parameters()).keys()
    for name, p in net.named_parameters():
        np.testing.assert_allclose(n(p.grad), n(jg[name]), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_converter_round_trip_and_npz_keys(case):
    params, net = case["params"], case["net"]
    back = params_to_flax(params_from_flax(params), net)
    ref = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_leaves_with_path(back)}
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    npz = npz_from_state_dict(net.state_dict(), net)
    assert npz.keys() == ref.keys()
    sd = state_dict_from_npz(npz)
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("size,kernel,stride,want", [
    (32, 3, 2, (0, 1)), (33, 3, 2, (1, 1)), (32, 4, 1, (1, 2)),
    (33, 4, 2, (1, 2)), (32, 4, 2, (1, 1)), (7, 1, 2, (0, 0)),
    (5, 3, 1, (1, 1)), (5, 7, 1, (3, 3))])
def test_same_padding_is_flax(size, kernel, stride, want):
    """SameConv2d pads as flax.linen.Conv(padding="SAME") does."""
    assert same_padding(size, kernel, stride) == want
    from flax import linen as fnn
    x = np.random.default_rng(2).standard_normal(
        (1, size, size + 1, 2)).astype(np.float32)
    conv = fnn.Conv(3, (kernel, kernel), strides=(stride, stride),
                    padding="SAME")
    params = _np(conv.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    ref = np.asarray(conv.apply(params, jnp.asarray(x)))
    port = SameConv2d(2, 3, kernel, stride)
    port.load_state_dict({
        "weight": t(params["params"]["kernel"].transpose(3, 2, 0, 1)),
        "bias": t(params["params"]["bias"])})
    with torch.no_grad():
        got = n(port(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(mode, real):
    pred = np.random.default_rng(3).standard_normal(
        (2, 5, 4, 1)).astype(np.float32) * 3
    pred[0, 0, 0, 0] = 0.0   # vanilla's max(p, 0) at its tie
    jl, jg = jax.value_and_grad(
        lambda p: jgan.gan_loss(p, real, mode))(jnp.asarray(pred))
    p = t(pred).requires_grad_(True)
    loss = gan_loss(p, real, mode)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    if mode == "vanilla":
        # |p|'s derivative at 0: JAX 1, torch 0 (multiplied by
        # d log1p(exp(-|p|)) = -1/2 there); elsewhere 1e-6
        np.testing.assert_allclose(n(p.grad).ravel()[1:],
                                   np.asarray(jg).ravel()[1:], rtol=1e-5,
                                   atol=1e-7)
    else:
        np.testing.assert_allclose(n(p.grad), np.asarray(jg), rtol=1e-5,
                                   atol=1e-7)
    with pytest.raises(ValueError):
        gan_loss(p, real, "hinge")


@pytest.mark.parametrize("mode", ["mixed", "real", "fake"])
def test_gradient_penalty_matches_jax(mode, monkeypatch):
    """The penalty and its gradient in the discriminator's weights, the
    port given JAX's mixing weights (``gan.penalty_alpha``)."""
    jd = jgan.NLayerDiscriminator(base=BASE, n_layers=2)
    rng = np.random.default_rng(4)
    real = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    fake = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    params = _np(jd.init(jax.random.PRNGKey(0), jnp.asarray(real)))
    key = jax.random.PRNGKey(9)
    alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1)))

    def jpen(p):
        return jgan.gradient_penalty(jd.apply, p, jnp.asarray(real),
                                     jnp.asarray(fake), key, mode=mode)

    jv, jgp = jax.value_and_grad(jpen)(params)
    jg = params_from_flax(_np(jgp))

    def from_jax(shape, generator, device):
        assert tuple(shape) == alpha.shape
        return t(alpha)

    monkeypatch.setattr(gan, "penalty_alpha", from_jax)
    disc = NLayerDiscriminator(2, base=BASE, n_layers=2)
    disc.load_state_dict(params_from_flax(params))
    pen = gradient_penalty(disc, t(real), t(fake), mode=mode)
    pen.backward()
    # a second-order gradient through float32 convolutions: 1e-5 of the
    # value, weights 1e-4 relative and 1e-5 of the largest entry
    np.testing.assert_allclose(pen.item(), float(jv), rtol=1e-5)
    scale = max(float(g.abs().max()) for g in jg.values())
    for name, p in disc.named_parameters():
        # the head's bias does not reach the input gradient: no grad in
        # torch, zeros in JAX
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(n(got), n(jg[name]), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_gradient_penalty_alpha_from_generator():
    disc = define_discriminator("pixel", in_channels=1, base=BASE,
                                generator=torch.Generator().manual_seed(0))
    real, fake = torch.rand(3, 4, 4, 1), torch.rand(3, 4, 4, 1)
    a = gradient_penalty(disc, real, fake, torch.Generator().manual_seed(1))
    b = gradient_penalty(disc, real, fake, torch.Generator().manual_seed(1))
    c = gradient_penalty(disc, real, fake, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not real.requires_grad


@pytest.mark.parametrize("as_tensor", [False, True])
def test_image_pool_draws_match_jax(as_tensor):
    jpool, pool = jgan.ImagePool(3, seed=5), ImagePool(3, seed=5)
    rng = np.random.default_rng(6)
    for _ in range(8):
        imgs = rng.standard_normal((2, 4, 4, 1)).astype(np.float32)
        ref = jpool.query(imgs)
        got = pool.query(t(imgs) if as_tensor else imgs.copy())
        assert isinstance(got, torch.Tensor) == as_tensor
        np.testing.assert_array_equal(n(got), ref)
    assert ImagePool(0).query(imgs) is imgs


def test_define_discriminator():
    assert isinstance(define_discriminator("basic", in_channels=2),
                      NLayerDiscriminator)
    assert isinstance(define_discriminator("pixel", in_channels=2),
                      PixelDiscriminator)
    d = define_discriminator("n_layers", in_channels=2, base=32, n_layers=3)
    assert [c.out_channels for c in d.convs] == [32, 64, 128, 256]
    with pytest.raises(KeyError):
        define_discriminator("patch", in_channels=2)
