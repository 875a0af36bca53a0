"""The deep-image-prior generators in plain PyTorch, as functions of a
dict of weights by name: Auto22 (shot gathers -> velocity map in [0, 1])
and AutoElMar22 (vx and vz gathers -> per-field deltas).

Layers (NCHW inside, NHWC at the interface): the encoder keeps every
``time_decimation``-th time sample, then per filter width a block of two
3x3 convs, each with GroupNorm (the largest divisor of the width up to 8
groups, eps 1e-6) and LeakyReLU(0.1), and a floor 2x2 average pool; the
NHWC flatten goes to a Dense of ``latent_dim``.  The decoder's Dense
fills [h0, w0, widest], h0 = ceil(nz / 8) + 1 (w0 alike); each stage a
half-pixel bilinear 2x upsample and a conv block; crop to [nz, nx]; a
1x1 conv; sigmoid (Auto22) or nothing (AutoElMar22's linear head).
AutoElMar22 first mixes each component's shots into 4 channels with a
1x1 conv and concatenates vx's and vz's, and decodes one branch per field.

``precision="tf32"`` computes every convolution and Dense with TF32
operands: on a card through the backends' TF32 switches, on the CPU by
rounding the operands to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NORM_EPS = 1e-6
SLOPE = 0.1


def groups_for(c: int, cap: int = 8) -> int:
    for g in range(min(cap, c), 0, -1):
        if c % g == 0:
            return g
    return 1


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa
    bits, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Precision:
    """The arithmetic of the convolutions and Dense layers: "fp32" (TF32
    off) or "tf32"."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "tf32"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    @contextlib.contextmanager
    def switches(self, device):
        """The backends' TF32 switches set for this precision on a card."""
        if torch.device(device).type != "cuda":
            yield
            return
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old

    def operands(self, *xs):
        if self.name == "tf32" and xs[0].device.type == "cpu":
            return tuple(None if x is None else _RoundTF32.apply(x)
                         for x in xs)
        return xs


class _RoundTF32(torch.autograd.Function):
    """TF32 rounding in the forward, the gradient passed through (the
    tensor cores round the backward's operands too; on the CPU the
    emulation rounds only the forward's)."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _conv(p, name, x, prec, padding=0):
    x, w = prec.operands(x, p[name + ".weight"])
    return F.conv2d(x, w, p[name + ".bias"], padding=padding)


def _dense(p, name, x, prec):
    x, w = prec.operands(x, p[name + ".weight"])
    return F.linear(x, w, p[name + ".bias"])


def _block(p, name, x, prec):
    for i in range(2):
        x = _conv(p, f"{name}.convs.{i}", x, prec, padding=1)
        c = x.shape[1]
        x = F.group_norm(x, groups_for(c), p[f"{name}.norms.{i}.weight"],
                         p[f"{name}.norms.{i}.bias"], NORM_EPS)
        x = F.leaky_relu(x, SLOPE)
    return x


def encode(p, name, shots, arch, prec):
    """[B, nt, nr, C] gathers -> latent [B, latent_dim]."""
    x = shots[:, :: arch["time_decimation"]].permute(0, 3, 1, 2)
    for k in range(len(arch["filters"])):
        x = F.avg_pool2d(_block(p, f"{name}.downs.{k}.block", x, prec), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return _dense(p, f"{name}.fc", x, prec)


def decode(p, name, z, arch, prec, final):
    """latent -> [B, nz, nx, 1]."""
    f = arch["filters"]
    nz, nx = arch["out_shape"]
    s = 2 ** (len(f) - 1)
    h0, w0 = math.ceil(nz / s) + 1, math.ceil(nx / s) + 1
    x = _dense(p, f"{name}.fc", z, prec).reshape(-1, h0, w0, f[-1])
    x = x.permute(0, 3, 1, 2)
    for k in range(len(f) - 1):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        x = _block(p, f"{name}.ups.{k}.block", x, prec)
    x = _conv(p, f"{name}.head", x[:, :, :nz, :nx], prec)
    if final == "sigmoid":
        x = torch.sigmoid(x)
    return x.permute(0, 2, 3, 1)


def auto22(p, shots, arch, prec):
    """Auto22: gathers [1, nt, nr, ns] -> field in [0, 1] [1, nz, nx, 1]."""
    return decode(p, "decoder", encode(p, "encoder", shots, arch, prec),
                  arch, prec, "sigmoid")


def autoelmar22(p, vx, vz, arch, prec):
    """AutoElMar22 with the linear head: gathers -> deltas [1, nz, nx, F]."""
    def mix(name, x):
        x, w = prec.operands(x.permute(0, 3, 1, 2), p[name + ".weight"])
        return F.conv2d(x, w, p[name + ".bias"]).permute(0, 2, 3, 1)

    x = torch.cat([mix("combine_vx", vx), mix("combine_vz", vz)], dim=-1)
    z = encode(p, "encoder", x, arch, prec)
    return torch.cat([decode(p, f"decoder_field{k}", z, arch, prec, "none")
                      for k in range(arch["n_fields"])], dim=-1)


def _block_spec(name, cin, cout):
    out = []
    for i, ci in enumerate((cin, cout)):
        out += [(f"{name}.convs.{i}.weight", (cout, ci, 3, 3), "kernel",
                 ci * 9),
                (f"{name}.convs.{i}.bias", (cout,), "bias", 0),
                (f"{name}.norms.{i}.weight", (cout,), "scale", 0),
                (f"{name}.norms.{i}.bias", (cout,), "bias", 0)]
    return out


def _dense_spec(name, fin, fout):
    return [(name + ".weight", (fout, fin), "kernel", fin),
            (name + ".bias", (fout,), "bias", 0)]


def _conv1_spec(name, cin, cout):
    return [(name + ".weight", (cout, cin, 1, 1), "kernel", cin),
            (name + ".bias", (cout,), "bias", 0)]


def _encoder_spec(name, in_shape, arch):
    nt, nr, c = in_shape
    f = arch["filters"]
    out = []
    for k, (ci, co) in enumerate(zip([c, *f], f)):
        out += _block_spec(f"{name}.downs.{k}.block", ci, co)
    h, w = -(-nt // arch["time_decimation"]), nr
    for _ in f:
        h, w = h // 2, w // 2
    return out + _dense_spec(f"{name}.fc", h * w * f[-1], arch["latent_dim"])


def _decoder_spec(name, arch):
    f = arch["filters"]
    nz, nx = arch["out_shape"]
    s = 2 ** (len(f) - 1)
    h0, w0 = math.ceil(nz / s) + 1, math.ceil(nx / s) + 1
    out = _dense_spec(f"{name}.fc", arch["latent_dim"], h0 * w0 * f[-1])
    chans = [f[-1], *reversed(f[:-1])]
    for k, (ci, co) in enumerate(zip(chans, chans[1:])):
        out += _block_spec(f"{name}.ups.{k}.block", ci, co)
    return out + _conv1_spec(f"{name}.head", f[0], 1)


def spec(arch: dict) -> list:
    """[(name, shape, kind, fan_in)] of the generator's weights, in a
    fixed order; ``kind`` is "kernel", "bias" or "scale"."""
    nt, nr, ns = arch["in_shape"]
    if arch["net"] == "Auto22":
        return (_encoder_spec("encoder", (nt, nr, ns), arch)
                + _decoder_spec("decoder", arch))
    out = _conv1_spec("combine_vx", ns, 4) + _conv1_spec("combine_vz", ns, 4)
    out += _encoder_spec("encoder", (nt, nr, 8), arch)
    for k in range(arch["n_fields"]):
        out += _decoder_spec(f"decoder_field{k}", arch)
    return out
