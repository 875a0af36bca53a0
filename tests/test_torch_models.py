"""The Auto22 generator: the port against the Flax net with the same
weights (carried by models/convert.py), the converter, the registry,
and the Flax parity hazards (resize, init)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.models import (
    AutoEncoderNet as JAutoEncoderNet,
    apply_velocity_output as j_apply_velocity_output,
)
from physicsbasedfwi2_tpu.models.blocks import resize_2x as j_resize_2x
from physicsbasedfwi2_tpu_torch.models import (
    AutoEncoderNet, UNet, apply_velocity_output, define_generator,
    pack_output,
)
from physicsbasedfwi2_tpu_torch.models.blocks import (
    num_groups_for, resize_2x,
)
from physicsbasedfwi2_tpu_torch.models.convert import (
    npz_from_state_dict, params_from_flax, params_to_flax,
    state_dict_from_npz,
)

from torch_parity import n, t

torch.set_num_threads(1)

FILTERS = (4, 8, 16)
OUT = (20, 24)
IN = (1, 64, 16, 3)   # [B, nt, nr, ns]


@pytest.fixture(scope="module")
def nets():
    x = np.random.default_rng(0).standard_normal(IN).astype(np.float32)
    jnet = JAutoEncoderNet(out_shape=OUT, filters=FILTERS)
    # jitted: one compile instead of op-by-op dispatch
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                       jnp.asarray(x)))
    net = AutoEncoderNet(out_shape=OUT, in_shape=IN[1:], filters=FILTERS)
    net.load_state_dict(params_from_flax(params))
    return jnet, params, net, x


def test_auto22_forward_matches_flax(nets):
    jnet, params, net, x = nets
    jf, jz = jax.jit(jnet.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        f, z = net(t(x))
    assert f.shape == jf.shape and z.shape == jz.shape
    # float32 convolutions and GroupNorm statistics summed in another
    # order (and Flax's E[x^2]-E[x]^2 variance): 1e-5 of max
    for got, ref in ((f, jf), (z, jz)):
        np.testing.assert_allclose(
            n(got), np.asarray(ref), rtol=1e-5,
            atol=1e-5 * float(jnp.abs(ref).max()))


def test_auto22_vjp_matches_flax(nets):
    jnet, params, net, x = nets
    rng = np.random.default_rng(1)
    wf = rng.standard_normal((1,) + OUT + (1,)).astype(np.float32)
    wz = rng.standard_normal((1, 8)).astype(np.float32)

    def scalar(p):
        f, z = jnet.apply(p, jnp.asarray(x))
        return jnp.sum(f * wf) + jnp.sum(z * wz)

    jg = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(scalar))(params)))
    net.zero_grad()
    f, z = net(t(x))
    (torch.sum(f * t(wf)) + torch.sum(z * t(wz))).backward()
    scale = max(float(g.abs().max()) for g in jg.values())
    for name, p in net.named_parameters():
        # 1e-5 of the largest gradient entry: conv biases that feed a
        # one-channel GroupNorm group have a zero gradient, which both
        # frameworks return as rounding noise
        np.testing.assert_allclose(n(p.grad), n(jg[name]), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_converter_round_trip_and_npz_keys(nets):
    _, params, net, _ = nets
    back = params_to_flax(params_from_flax(params), net)
    flat_ref = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_leaves_with_path(params)}
    flat_back = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_leaves_with_path(back)}
    assert flat_ref.keys() == flat_back.keys()
    for k in flat_ref:
        np.testing.assert_array_equal(flat_back[k], flat_ref[k])
    npz = npz_from_state_dict(net.state_dict(), net)
    assert npz.keys() == flat_ref.keys()
    sd = state_dict_from_npz(npz)
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v)


def test_define_generator_filters_kwargs_and_names():
    net = define_generator("auto22", out_shape=OUT, in_shape=IN[1:],
                           filters=FILTERS, latent_dim=5, kl_weight=1.0,
                           not_a_field=3)
    assert isinstance(net, AutoEncoderNet)
    assert net.encoder.fc.out_features == 5
    for name in ("Auto", "Auto23", "AutoWav", "Simple24", "AutoN"):
        assert isinstance(define_generator(
            name, out_shape=OUT, in_shape=IN[1:], filters=FILTERS),
            AutoEncoderNet)
    # Auto22CBAM, Unet22 and the supervised engine's FNO build; a name no
    # registry knows raises
    net = define_generator("Auto22CBAM", out_shape=OUT, in_shape=IN[1:],
                           filters=FILTERS)
    assert isinstance(net, AutoEncoderNet) and net.decoder.cbams is not None
    assert isinstance(define_generator("Unet22", out_shape=OUT,
                                       in_shape=IN[1:], filters=FILTERS),
                      UNet)
    assert type(define_generator("FNO", out_shape=OUT,
                                 in_shape=IN[1:])).__name__ == "FNO2d"
    with pytest.raises(KeyError, match="unknown generator"):
        define_generator("NoSuchNet", out_shape=OUT, in_shape=IN[1:])
    out = pack_output((torch.zeros(1), torch.ones(1)))
    assert out.latent is not None and out.mu is None


@pytest.mark.parametrize("hw", [(5, 7), (8, 8)])
def test_resize_2x_matches_jax_image_resize(hw):
    x = np.random.default_rng(2).standard_normal((2,) + hw + (3,)).astype(
        np.float32)
    ref = np.asarray(j_resize_2x(jnp.asarray(x)))
    got = n(resize_2x(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    # two-tap interpolation weights 1/4, 3/4: a rounding apart
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_init_is_flax_lecun_normal():
    net = define_generator("Auto22", out_shape=(151, 200),
                           in_shape=(1000, 200, 18),
                           generator=torch.Generator().manual_seed(0))
    conv = net.encoder.downs[1].block.convs[0]
    fan_in = conv.weight[0].numel()
    w = n(conv.weight).ravel()
    std = np.sqrt(1.0 / fan_in)
    # truncated at 2 stddev of the underlying normal, rescaled to unit
    # variance: |w| < 2 std / 0.8796, sample std ~ std (4608 draws)
    assert np.abs(w).max() <= 2.0 * std / 0.87962566103423978 + 1e-7
    assert abs(w.std() / std - 1.0) < 0.05
    assert float(conv.bias.detach().abs().max()) == 0.0
    assert float(net.decoder.fc.bias.detach().abs().max()) == 0.0
    norm = net.encoder.downs[0].block.norms[0]
    assert norm.eps == 1e-6 and norm.num_groups == num_groups_for(16)
    again = define_generator("Auto22", out_shape=(151, 200),
                             in_shape=(1000, 200, 18),
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.encoder.fc.weight, net.encoder.fc.weight)


def test_apply_velocity_output_matches_jax():
    rng = np.random.default_rng(3)
    f01 = rng.random((1, 6, 5, 1)).astype(np.float32)
    true = rng.uniform(1600, 3000, (1, 6, 5, 1)).astype(np.float32)
    true[:, :2] = 1500.0
    ref = j_apply_velocity_output(jnp.asarray(f01), jnp.asarray(true))
    got = apply_velocity_output(t(f01), t(true))
    np.testing.assert_array_equal(n(got), np.asarray(ref))
