"""The generator zoo (BASELINE config 2's Unet22, Att, the VAEs, AutoNF,
Auto22CBAM and Auto22 with norm="layer"; the supervised engine's U-Nets
ASPP, MultiASPP, ResUNET, UNet3Plus, R2U, R2AttU, Multi and Multi2): each
port against its Flax net with the same weights (carried by
models/convert.py), the converter both ways for every family, and the
blocks the zoo adds.

The input is odd ([1, 401, 11, 3]) and the model grid (32, 40) wider
than the U-Net's output, so ``match_spatial`` pads, ``fit_to_shape``
upscales, ResUNET's stride-2 convs pad (1, 1), and UNet3Plus and
MultiScaleUNet shrink by non-integer factors (``jax.image.resize``
antialiases there).  The "-image" cases are the supervised use: an even
[1, 32, 40, 1] image in, the same size out (no ``out_shape``), where
ResUNET's stride-2 convs pad (0, 1).  A VAE's noise is the Flax call's own: Flax is handed
``rng_key`` and the port ``jax.random.normal(rng_key, mu.shape)`` through
``vae.latent_noise``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from physicsbasedfwi2_tpu.models import define_generator as j_define
from physicsbasedfwi2_tpu.models.blocks import (
    fit_to_shape as j_fit_to_shape, match_spatial as j_match_spatial,
)
from physicsbasedfwi2_tpu.models.flows import (
    PlanarFlowStack as JPlanarFlowStack,
)
from physicsbasedfwi2_tpu.models.vae import kl_divergence as j_kl
from physicsbasedfwi2_tpu.models import _GENERATORS as J_GENERATORS
from physicsbasedfwi2_tpu_torch.models import (
    ASPPUNet, AutoEncoderNet, FNO2d, FlowAutoEncoderNet, ModelVae,
    MultiScaleUNet, PlanarFlowStack, R2UNet, ResnetGenerator,
    ResUNetPlusPlus, UNet, UNet3Plus, VaeFlowNet, VaeNet, define_generator,
    kl_divergence, pack_output,
)
from physicsbasedfwi2_tpu_torch.models import _GENERATORS
from physicsbasedfwi2_tpu_torch.models import vae
from physicsbasedfwi2_tpu_torch.models.blocks import (
    ChannelLayerNorm, fit_to_shape, match_spatial,
)
from physicsbasedfwi2_tpu_torch.models.convert import (
    npz_from_state_dict, params_from_flax, params_to_flax,
    state_dict_from_npz,
)

from torch_parity import n, rel_max, t

torch.set_num_threads(1)

FILTERS = (4, 8)
LATENT = 8
OUT = (32, 40)
SHOTS = (1, 401, 11, 3)   # [B, nt, nr, ns]: odd sizes
IMG = (1, 32, 40, 1)      # ModelVae's velocity image
KEY = jax.random.PRNGKey(5)

# case -> (registry name, net overrides, input shape, call keywords)
CASES = {
    "Unet22": ("Unet22", {}, SHOTS, {}),
    "Unet22-tanh": ("Unet22", {"final_activation": "tanh"}, SHOTS, {}),
    "Unet22-none": ("Unet22", {"final_activation": "none"}, SHOTS, {}),
    "Att": ("Att", {}, SHOTS, {}),
    "Vae2": ("Vae2", {}, SHOTS, {"deterministic": False}),
    "VaeNormalizingPhy": ("VaeNormalizingPhy", {}, SHOTS,
                          {"deterministic": False}),
    "VaeNoPhy": ("VaeNoPhy", {}, IMG, {"deterministic": False}),
    "AutoNF": ("AutoNF", {}, SHOTS, {}),
    "AutoNF-reverse": ("AutoNF", {}, SHOTS, {"reverse": True}),
    "Auto22CBAM": ("Auto22CBAM", {}, SHOTS, {}),
    "Auto22-layer": ("Auto22", {"norm": "layer"}, SHOTS, {}),
    "ASPP": ("ASPP", {}, SHOTS, {}),
    "MultiASPP": ("MultiASPP", {}, SHOTS, {}),
    "ResUNET": ("ResUNET", {}, SHOTS, {}),
    "UNet3Plus": ("UNet3Plus", {}, SHOTS, {}),
    "R2U": ("R2U", {}, SHOTS, {}),
    "R2AttU": ("R2AttU", {}, SHOTS, {}),
    "Multi": ("Multi", {}, SHOTS, {}),
    "Multi2": ("Multi2", {}, SHOTS, {}),
    "unet_128-image": ("unet_128", {"out_shape": None}, IMG, {}),
    "ResUNET-image": ("ResUNET", {"out_shape": None}, IMG, {}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(Flax net, its params, the port net with the same weights, the
    input, the Flax apply and the port call for the case)."""
    name, over, shape, kw = CASES[request.param]
    over = dict(over)
    out_shape = over.pop("out_shape", OUT)
    rng = np.random.default_rng(0)
    x = (rng.random(shape) if shape == IMG
         else rng.standard_normal(shape)).astype(np.float32)
    jnet = j_define(name, out_shape=out_shape, filters=FILTERS,
                    latent_dim=LATENT, **over)
    # jitted: one compile instead of op-by-op dispatch
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jnet.init)(
        {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
        jnp.asarray(x)))
    net = define_generator(name, out_shape=out_shape, in_shape=shape[1:],
                           filters=FILTERS, latent_dim=LATENT, **over)
    net.load_state_dict(params_from_flax(params))
    stochastic = kw.get("deterministic") is False
    if stochastic:
        japply = jax.jit(functools.partial(jnet.apply, deterministic=False))
        jcall = functools.partial(japply, rng_key=KEY)
    else:
        jcall = jax.jit(functools.partial(jnet.apply, **kw))
    eps = np.asarray(jax.random.normal(KEY, (1, LATENT)))

    def pcall(xt):
        if not stochastic:
            return net(xt, **kw)
        return net(xt, deterministic=False, generator=torch.Generator())

    return dict(name=request.param, jnet=jnet, params=params, net=net, x=x,
                jcall=jcall, pcall=pcall, eps=eps, stochastic=stochastic)


def _noise_from_flax(case, monkeypatch):
    """Feed the Flax call's reparameterization noise to the port."""
    if case["stochastic"]:
        eps = t(case["eps"])

        def from_flax(shape, generator):
            assert tuple(shape) == tuple(eps.shape)
            return eps

        monkeypatch.setattr(vae, "latent_noise", from_flax)


def test_forward_matches_flax(case, monkeypatch):
    _noise_from_flax(case, monkeypatch)
    ref = [np.asarray(o) for o in case["jcall"](case["params"],
                                                jnp.asarray(case["x"]))
           if o is not None]
    with torch.no_grad():
        got = [o for o in case["pcall"](t(case["x"])) if o is not None]
    assert len(got) == len(ref)
    assert got[0].shape == ref[0].shape == (1, *OUT, 1)
    # float32 convolutions and norm statistics summed in another order:
    # 1e-5 of max
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(n(g), r, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(r).max()))


def test_vjp_matches_flax(case, monkeypatch):
    _noise_from_flax(case, monkeypatch)
    jcall, params, x = case["jcall"], case["params"], jnp.asarray(case["x"])
    outs = [o for o in jcall(params, x) if o is not None]
    rng = np.random.default_rng(1)
    ws = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]

    def scalar(p):
        return sum(jnp.sum(o * w) for o, w in zip(
            [o for o in jcall(p, x) if o is not None], ws))

    jg = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(scalar))(params)))
    net = case["net"]
    net.zero_grad()
    got = [o for o in case["pcall"](t(case["x"])) if o is not None]
    sum(torch.sum(o * t(w)) for o, w in zip(got, ws)).backward()
    scale = max(float(g.abs().max()) for g in jg.values())
    assert jg.keys() == dict(net.named_parameters()).keys()
    for name, p in net.named_parameters():
        # 1e-5 of the largest gradient entry (as test_torch_models.py):
        # conv biases that feed a one-channel GroupNorm group have a zero
        # gradient, which both frameworks return as rounding noise
        np.testing.assert_allclose(n(p.grad), n(jg[name]), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_converter_round_trip_and_npz_keys(case):
    params, net = case["params"], case["net"]
    back = params_to_flax(params_from_flax(params), net)
    flat_ref = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_leaves_with_path(params)}
    flat_back = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_leaves_with_path(back)}
    assert flat_ref.keys() == flat_back.keys()
    for k in flat_ref:
        np.testing.assert_array_equal(flat_back[k], flat_ref[k])
    # the npz of a port checkpoint has the JAX checkpoint's keys, and
    # loads back bit for bit
    npz = npz_from_state_dict(net.state_dict(), net)
    assert npz.keys() == flat_ref.keys()
    sd = state_dict_from_npz(npz)
    assert sd.keys() == net.state_dict().keys()
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("names,cls", [
    (("Unet", "UnetPre", "Unet22", "classic", "NewU", "unet_128",
      "unet_256", "Att"), UNet),
    (("Vae", "Vae2", "Vae3", "VaeLatentNoPhy", "VaeLatent2NoPhy"), VaeNet),
    (("VaeNoPhy", "Vaevel"), ModelVae),
    (("VaeNormalizing", "VaeNormalizingPhy"), VaeFlowNet),
    (("AutoNF",), FlowAutoEncoderNet),
    (("Auto22CBAM",), AutoEncoderNet),
    (("ASPP", "MultiASPP"), ASPPUNet),
    (("ResUNET",), ResUNetPlusPlus),
    (("UNet3Plus",), UNet3Plus),
    (("R2U", "R2AttU"), R2UNet),
    (("Multi", "Multi2"), MultiScaleUNet),
    (("FNO",), FNO2d),
    (("resnet_6blocks", "resnet_9blocks"), ResnetGenerator),
])
def test_define_generator_builds_the_zoo(names, cls):
    for name in names:
        net = define_generator(name, out_shape=OUT, in_shape=SHOTS[1:],
                               filters=FILTERS, latent_dim=LATENT,
                               time_decimation=4, dropout=0.0,
                               generator=torch.Generator().manual_seed(0))
        assert isinstance(net, cls), name
    if cls is UNet:
        # in_channels comes from in_shape; Att gates its skips with CBAM
        assert net.blocks[0].convs[0].in_channels == SHOTS[-1]
        assert net.cbams is not None and len(net.cbams) == len(FILTERS)
        assert define_generator("Unet22", out_shape=OUT, in_shape=SHOTS[1:],
                                filters=FILTERS).cbams is None
    if cls is AutoEncoderNet:
        assert len(net.decoder.cbams) == len(FILTERS) - 1
    if cls is R2UNet:
        # R2AttU gates its skips with CBAM, R2U does not
        assert net.cbams is not None and len(net.cbams) == len(FILTERS)
        assert define_generator("R2U", in_shape=SHOTS[1:],
                                filters=FILTERS).cbams is None
    if cls is ResnetGenerator:
        assert len(net.resblocks) == 9
        assert len(define_generator("resnet_6blocks", in_shape=SHOTS[1:],
                                    base=8).resblocks) == 6


def test_registry_has_every_jax_name():
    """define_generator builds every name of the JAX registry, with the
    JAX defaults."""
    assert set(_GENERATORS) == set(J_GENERATORS)
    for key, (_, defaults) in J_GENERATORS.items():
        assert _GENERATORS[key][1] == defaults, key


def test_vae_latent_draws():
    """z = mu when deterministic; otherwise mu + exp(logvar / 2) eps with
    eps from the caller's generator (reproducible by seed), and no
    generator is an error."""
    net = define_generator("Vae2", out_shape=OUT, in_shape=SHOTS[1:],
                           filters=FILTERS, latent_dim=LATENT,
                           generator=torch.Generator().manual_seed(0))
    x = t(np.random.default_rng(2).standard_normal(SHOTS).astype(np.float32))
    with torch.no_grad():
        f0, mu, logvar, z0 = net(x)
        assert torch.equal(z0, mu)
        _, _, _, z1 = net(x, deterministic=False,
                          generator=torch.Generator().manual_seed(3))
        f2, _, _, z2 = net(x, deterministic=False,
                           generator=torch.Generator().manual_seed(3))
        eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(3))
        assert torch.equal(z1, z2)
        torch.testing.assert_close(z1, mu + torch.exp(0.5 * logvar) * eps)
        assert torch.equal(net.decode(z2), f2)
        assert not torch.equal(f2, f0)
    with pytest.raises(ValueError, match="Generator"):
        net(x, deterministic=False)
    assert len(pack_output(net(x)).mu) == 1


def test_planar_flow_stack_matches_jax():
    z = np.random.default_rng(3).standard_normal((5, LATENT)).astype(
        np.float32)
    jstack = JPlanarFlowStack(n_flows=8)
    params = jax.tree_util.tree_map(np.asarray, jstack.init(
        jax.random.PRNGKey(4), jnp.asarray(z)))
    # a strong b so that tanh saturates in places
    params["params"]["flow1"]["b"] = np.float32(1.5)
    jz, jld = jstack.apply(params, jnp.asarray(z))
    stack = PlanarFlowStack(LATENT)
    stack.load_state_dict({f"{k}.{leaf}": torch.tensor(np.asarray(v))
                           for k, d in params["params"].items()
                           for leaf, v in d.items()})
    with torch.no_grad():
        pz, pld = stack(t(z))
    assert pld.shape == jld.shape == (5,)
    np.testing.assert_allclose(n(pz), np.asarray(jz), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(pld), np.asarray(jld), rtol=1e-5,
                               atol=1e-6)


def test_planar_flow_init_from_generator():
    a = PlanarFlowStack(LATENT, torch.Generator().manual_seed(0))
    b = PlanarFlowStack(LATENT, torch.Generator().manual_seed(0))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    u = torch.stack([a.get_submodule(f"flow{i}").u.detach()
                     for i in range(8)])
    assert abs(float(u.std()) / 0.1 - 1) < 0.3   # N(0, 0.1^2), 64 draws
    assert all(float(a.get_submodule(f"flow{i}").b.detach()) == 0.0
               for i in range(8))


def test_kl_divergence_matches_jax():
    rng = np.random.default_rng(4)
    mu = rng.standard_normal((3, LATENT)).astype(np.float32)
    logvar = rng.standard_normal((3, LATENT)).astype(np.float32)
    np.testing.assert_allclose(float(kl_divergence(t(mu), t(logvar))),
                               float(j_kl(jnp.asarray(mu),
                                          jnp.asarray(logvar))), rtol=1e-6)
    assert float(kl_divergence(torch.zeros(2, 4), torch.zeros(2, 4))) == 0.0


@pytest.mark.parametrize("shape,out", [((7, 5), (10, 13)),
                                       ((12, 5), (9, 13)),
                                       ((11, 40), (32, 40)),
                                       ((9, 9), (4, 6))])
def test_fit_to_shape_matches_jax_image_resize(shape, out):
    x = np.random.default_rng(5).standard_normal((1, *shape, 3)).astype(
        np.float32)
    ref = np.asarray(j_fit_to_shape(jnp.asarray(x), out))
    got = n(fit_to_shape(t(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1))
    assert got.shape == ref.shape == (1, *out, 3)
    # non-integer scales: the source positions round apart
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,hw", [((5, 7), (6, 6)), ((8, 4), (5, 9)),
                                      ((4000, 2), (4001, 5)),
                                      ((6, 6), (6, 6))])
def test_match_spatial_matches_jax(shape, hw):
    x = np.random.default_rng(6).standard_normal((1, *shape, 2)).astype(
        np.float32)
    ref = np.asarray(j_match_spatial(jnp.asarray(x), *hw))
    got = n(match_spatial(t(x).permute(0, 3, 1, 2), *hw).permute(0, 2, 3, 1))
    np.testing.assert_array_equal(got, ref)


def test_channel_layer_norm_is_flax_layernorm():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(4).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    ref = fnn.LayerNorm().apply({"params": {"scale": scale, "bias": bias}},
                                jnp.asarray(x))
    ln = ChannelLayerNorm(4)
    assert ln.eps == 1e-6
    ln.load_state_dict({"weight": t(scale), "bias": t(bias)})
    with torch.no_grad():
        got = ln(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert rel_max(got, ref) <= 1e-6


@pytest.fixture(scope="module")
def small_acoustic():
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        SyntheticAcousticWorkload)
    return SyntheticAcousticWorkload.build(
        nz=40, nx=48, nt=400, dt=0.001, num_shots=4, num_receivers=24,
        water_rows=6, chunk=25, pml_width=12, device="cpu")


@pytest.mark.parametrize("netg", ["ASPP", "ResUNET", "UNet3Plus", "R2U",
                                  "R2AttU", "Multi"])
def test_new_unets_train_in_the_acoustic_engine(netg, small_acoustic,
                                                tmp_path):
    """Each U-Net of the supervised family is also an acoustic DIP
    generator (the JAX test_every_registered_generator_trains): two
    finite steps on the fused path's plain version that move its
    weights."""
    import dataclasses
    from physicsbasedfwi2_tpu_torch.engine import config
    from physicsbasedfwi2_tpu_torch.engine.engines import AcousticDIPEngine
    wl = small_acoustic
    cfg = config.get_workload(
        "marmousi_acoustic", nz=40, nx=48, nt=400, dt=0.001, num_shots=4,
        num_receivers=24, chunk=25, pml_width=12, filters=(4, 8, 16),
        netG=netg, save_dir=str(tmp_path), direct_wave=False,
        validate_on_twin=False)
    e = AcousticDIPEngine(cfg, workload=dataclasses.replace(wl),
                          device="cpu")
    assert e.physics_path == "fused-plain"
    before = [p.detach().clone() for p in e.net.parameters()]
    for ep in (1, 2):
        rec = e.optimize_parameters(ep)
        assert all(np.isfinite(v) for v in rec.values()), rec
    assert any(not torch.equal(b, p) for b, p in zip(before,
                                                     e.net.parameters()))
