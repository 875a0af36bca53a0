"""Generator registry (port of ``physicsbasedfwi2_tpu/models/__init__.py``:
every name of the JAX registry, and ``define_discriminator``).

``define_generator`` maps a reference generator name to a configured
module; keyword arguments the module does not take are dropped, as
the JAX registry drops fields its Flax module lacks.  The nets that
size their layers from the input take ``in_shape``, one sample's (H, W,
C); a net that needs only its channel count (the U-Nets, FNO2d,
ResnetGenerator) gets ``in_channels`` from it.
"""

from __future__ import annotations

import inspect
from typing import Any, NamedTuple

from physicsbasedfwi2_tpu_torch.models.autoencoders import (
    AutoEncoderNet,
    ElasticAutoEncoderNet,
    FlowAutoEncoderNet,
    ModelParamNet,
    apply_elastic_output,
    apply_velocity_output,
)
from physicsbasedfwi2_tpu_torch.models.flows import (
    LatentFlow, PlanarFlowStack,
)
from physicsbasedfwi2_tpu_torch.models.fno import (
    FNO2d, SpectralConv1d, SpectralConv2d, lp_loss,
)
from physicsbasedfwi2_tpu_torch.models.gan import (
    ImagePool, NLayerDiscriminator, PixelDiscriminator, ResnetGenerator,
    gan_loss, gradient_penalty,
)
from physicsbasedfwi2_tpu_torch.models.unets import (
    ASPPUNet, MultiScaleUNet, R2UNet, ResUNetPlusPlus, UNet, UNet3Plus,
)
from physicsbasedfwi2_tpu_torch.models.vae import (
    ModelVae, VaeFlowNet, VaeNet, kl_divergence,
)

# name -> (factory, default kwargs)
_GENERATORS: dict[str, tuple[Any, dict[str, Any]]] = {}


def register_generator(name: str, factory, **defaults):
    _GENERATORS[name.lower()] = (factory, defaults)


def define_generator(name: str, out_shape: tuple[int, int] | None = None,
                     **overrides):
    """Instantiate a generator by reference-compatible name."""
    key = name.lower()
    if key not in _GENERATORS:
        raise KeyError(
            f"unknown generator {name!r}; known: {sorted(_GENERATORS)}")
    factory, defaults = _GENERATORS[key]
    kwargs = dict(defaults)
    kwargs.update(overrides)
    if out_shape is not None:
        kwargs["out_shape"] = out_shape
    accepted = set(inspect.signature(factory).parameters)
    if ("in_channels" in accepted and "in_channels" not in kwargs
            and kwargs.get("in_shape") is not None):
        kwargs["in_channels"] = kwargs["in_shape"][-1]
    kwargs = {k: v for k, v in kwargs.items() if k in accepted}
    return factory(**kwargs)


# --- deep-image-prior autoencoders (the reference's Auto* names) ---
for _n in ["Auto", "Auto21", "Auto22", "Auto23", "Auto24", "Auto25",
           "Auto26", "AutoWav", "Simple24", "AutoN"]:
    register_generator(_n, AutoEncoderNet)
register_generator("Auto22CBAM", AutoEncoderNet, use_cbam=True)

# --- elastic two-branch autoencoders ---
for _n in ["AutoEl22", "AutoElMar22", "AutoElFullMar22", "AutoSEAMMar22",
           "AutoRealData"]:
    register_generator(_n, ElasticAutoEncoderNet, n_fields=2)
register_generator("AutoElFullRhoMar22", ElasticAutoEncoderNet, n_fields=3)
# the reference's AutoElMarmousiMarZp22_Net is the rho-inversion net
# under a vestigial "Zp" label (three plain vp/vs/rho heads)
register_generator("AutoElMarZp22", ElasticAutoEncoderNet, n_fields=3)
# MC dropout (BASELINE config 5, mcdip_uq): dropout in each decoder block
register_generator("AutoElMarMCDIP22", ElasticAutoEncoderNet, n_fields=2,
                   dropout=0.1)

# --- U-Nets (seismic in, velocity out with out_shape) ---
for _n in ["Unet", "UnetPre", "Unet22", "classic", "NewU", "unet_128",
           "unet_256"]:
    register_generator(_n, UNet)
register_generator("Att", UNet, use_attention=True)
register_generator("ASPP", ASPPUNet)
register_generator("MultiASPP", ASPPUNet)
register_generator("ResUNET", ResUNetPlusPlus)
register_generator("UNet3Plus", UNet3Plus)
register_generator("R2U", R2UNet)
register_generator("R2AttU", R2UNet, use_attention=True)
register_generator("Multi", MultiScaleUNet)
register_generator("Multi2", MultiScaleUNet)

# --- VAEs ---
for _n in ["Vae", "Vae2", "Vae3", "VaeLatentNoPhy", "VaeLatent2NoPhy"]:
    register_generator(_n, VaeNet)
for _n in ["VaeNoPhy", "Vaevel"]:
    register_generator(_n, ModelVae)
# planar-flow VAEs
for _n in ["VaeNormalizing", "VaeNormalizingPhy"]:
    register_generator(_n, VaeFlowNet)

# --- flows / FNO / GAN generators ---
register_generator("AutoNF", FlowAutoEncoderNet)
register_generator("FNO", FNO2d)
register_generator("resnet_9blocks", ResnetGenerator, n_blocks=9)
register_generator("resnet_6blocks", ResnetGenerator, n_blocks=6)


class GenOut(NamedTuple):
    """Standard generator output (field [B, H, W, C], latent, VAE
    posterior stats, flow log|det J|)."""

    field: Any
    latent: Any = None
    mu: Any = None
    logvar: Any = None
    logdet: Any = None


def pack_output(out) -> GenOut:
    """Map a generator's raw return to GenOut by arity:
    (field, latent) | (field, latent, logdet) |
    (field, mu, logvar, z) | (field, mu, logvar, z, logdet)."""
    if not isinstance(out, tuple):
        return GenOut(out)
    if len(out) == 2:
        return GenOut(out[0], out[1])
    if len(out) == 3:
        return GenOut(out[0], out[1], logdet=out[2])
    if len(out) == 4:
        return GenOut(out[0], out[3], mu=out[1], logvar=out[2])
    if len(out) == 5:
        return GenOut(out[0], out[3], mu=out[1], logvar=out[2],
                      logdet=out[4])
    raise TypeError(f"unrecognized generator output arity {len(out)}")


def apply_generator(net, *inputs) -> GenOut:
    """Apply any registry generator and get a GenOut."""
    return pack_output(net(*inputs))


def define_discriminator(kind: str = "n_layers", **kwargs):
    """The discriminator by the reference's ``define_D`` kind: "n_layers"
    or "basic" (:class:`NLayerDiscriminator`), "pixel"
    (:class:`PixelDiscriminator`); ``in_channels`` is required."""
    if kind in ("n_layers", "basic"):
        return NLayerDiscriminator(**kwargs)
    if kind == "pixel":
        return PixelDiscriminator(**kwargs)
    raise KeyError(f"unknown discriminator {kind!r}")


__all__ = [
    "define_generator",
    "define_discriminator",
    "register_generator",
    "GenOut",
    "pack_output",
    "apply_generator",
    "AutoEncoderNet",
    "ElasticAutoEncoderNet",
    "FlowAutoEncoderNet",
    "ModelParamNet",
    "UNet",
    "ASPPUNet",
    "ResUNetPlusPlus",
    "UNet3Plus",
    "MultiScaleUNet",
    "R2UNet",
    "ResnetGenerator",
    "NLayerDiscriminator",
    "PixelDiscriminator",
    "gan_loss",
    "gradient_penalty",
    "ImagePool",
    "FNO2d",
    "SpectralConv1d",
    "SpectralConv2d",
    "lp_loss",
    "VaeNet",
    "VaeFlowNet",
    "ModelVae",
    "kl_divergence",
    "LatentFlow",
    "PlanarFlowStack",
    "apply_elastic_output",
    "apply_velocity_output",
]
