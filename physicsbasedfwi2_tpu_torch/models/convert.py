"""Carry generator weights between the Flax and PyTorch packages.

``params_from_flax`` maps a Flax params tree (nested dicts of arrays,
with or without the top ``'params'`` level) of any ported generator to
this package's ``state_dict``; ``params_to_flax`` is its inverse.  The
port's attribute names follow the Flax submodules':

- ``@nn.compact`` nets name a submodule by type and index:
  ``Encoder2D_0`` <-> ``encoder``, ``Down_i`` <-> ``downs.i``,
  ``UpCat_i`` <-> ``upcats.i``, ``CBAM_i`` <-> ``cbams.i``,
  ``AffineCoupling_i`` <-> ``couplings.i``, ``ResidualConv_i`` <->
  ``res.i``, ``SqueezeExcite_i`` <-> ``ses.i``, ``RecurrentConvBlock_i``
  <-> ``recs.i``, ``ResnetBlock_i`` <-> ``resblocks.i``, ``FNOBlock2d_i``
  <-> ``fnos.i``, ``ASPP_0`` <-> ``aspp``, ``SpectralConv2d_0`` <->
  ``spectral``, a U-Net's ``ConvBlock_k`` <-> ``blocks.k`` (a
  ``ConvBlock_0`` inside a stage <-> ``block``); ``Conv_j`` <->
  ``convs.j`` inside a ConvBlock, ASPP, ResidualConv,
  RecurrentConvBlock or ResnetBlock, ``conv`` inside an UpCat, a
  SpatialGate or an FNOBlock2d; elsewhere the last ``Conv_j`` of its
  level (the Flax nets create their output conv last) <-> ``head`` and
  the others <-> ``convs.j``; ``Dense_k`` <-> ``mlp.{2k}`` in a
  ChannelGate, a SqueezeExcite or an AffineCoupling (ReLUs between),
  else ``fc``;
- ``setup()`` nets (``VaeNet``, ``VaeFlowNet``, ``ModelVae``) name them by
  attribute (``encoder``, ``decoder``, ``flows``), as do the elastic
  net's ``combine_vx``/``combine_vz``/``decoder_field{k}`` and the
  planar flows' ``flow{i}``; those names are kept on both sides.

Layouts: conv kernels HWIO <-> OIHW; Dense kernels [in, out] <-> Linear
weights [out, in] (the port flattens and unflattens in NHWC order, so no
permutation of rows is needed); GroupNorm and LayerNorm ``scale``/
``bias`` <-> ``weight``/``bias``; the planar flows' ``u``, ``w``, ``b`` and
the spectral convs' ``w*_real``/``w*_imag`` as they are.

A state dict alone does not say whether its net is a ``setup()`` VAE or
which norm it uses, so the torch -> Flax direction takes the ``net``.

``npz_from_state_dict`` / ``state_dict_from_npz`` use the JAX package's
checkpoint keys (``jax.tree_util.keystr`` paths such as
``['params']['Encoder2D_0']['Dense_0']['kernel']``), so a
``<tag>_net_G.npz`` loads in either package.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.models.blocks import ChannelLayerNorm
from physicsbasedfwi2_tpu_torch.models.vae import ModelVae, VaeFlowNet, VaeNet

# Flax submodule name -> torch attribute path, per path component (the
# context-dependent ConvBlock_*, Conv_* and Dense_* in _torch_name)
_TO_TORCH = [
    (re.compile(r"Encoder2D_0|encoder"), "encoder"),
    (re.compile(r"Decoder2D_0|decoder"), "decoder"),
    (re.compile(r"LatentFlow_0"), "flow"),
    (re.compile(r"AffineCoupling_(\d+)"), r"couplings.\1"),
    (re.compile(r"Down_(\d+)"), r"downs.\1"),
    (re.compile(r"Up_(\d+)"), r"ups.\1"),
    (re.compile(r"UpCat_(\d+)"), r"upcats.\1"),
    (re.compile(r"CBAM_(\d+)"), r"cbams.\1"),
    (re.compile(r"ChannelGate_0"), "channel"),
    (re.compile(r"SpatialGate_0"), "spatial"),
    (re.compile(r"ResidualConv_(\d+)"), r"res.\1"),
    (re.compile(r"SqueezeExcite_(\d+)"), r"ses.\1"),
    (re.compile(r"RecurrentConvBlock_(\d+)"), r"recs.\1"),
    (re.compile(r"ResnetBlock_(\d+)"), r"resblocks.\1"),
    (re.compile(r"FNOBlock2d_(\d+)"), r"fnos.\1"),
    (re.compile(r"ASPP_0"), "aspp"),
    (re.compile(r"SpectralConv2d_0"), "spectral"),
    (re.compile(r"(?:Group|Layer)Norm_(\d+)"), r"norms.\1"),
    (re.compile(r"(combine_v[xz]|decoder_field\d+|flows|flow\d+)"), r"\1"),
]
# torch module lists -> Flax type names (index appended)
_LISTS = {"downs": "Down", "ups": "Up", "upcats": "UpCat", "cbams": "CBAM",
          "couplings": "AffineCoupling", "convs": "Conv",
          "blocks": "ConvBlock", "res": "ResidualConv",
          "ses": "SqueezeExcite", "recs": "RecurrentConvBlock",
          "resblocks": "ResnetBlock", "fnos": "FNOBlock2d"}
_SINGLE = {"block": "ConvBlock_0", "channel": "ChannelGate_0",
           "spatial": "SpatialGate_0", "conv": "Conv_0",
           "fc": "Dense_0", "flow": "LatentFlow_0", "aspp": "ASPP_0",
           "spectral": "SpectralConv2d_0"}
_NAMED = re.compile(r"combine_v[xz]|decoder_field\d+|flows|flow\d+")
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "u": "u", "w": "w", "b": "b",
           **{k: k for k in ("w_real", "w_imag", "w1_real", "w1_imag",
                             "w2_real", "w2_imag")}}
# Flax modules whose Conv_j is the port's convs.j, and those whose one
# Conv_0 is the port's conv
_CONV_LISTS = re.compile(r"(ConvBlock|ASPP|ResidualConv|RecurrentConvBlock|"
                         r"ResnetBlock)_\d+")
_CONV_SINGLE = re.compile(r"(UpCat|SpatialGate|FNOBlock2d)_\d+")
_KEY = re.compile(r"\['([^']*)'\]")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _last_convs(paths) -> dict[tuple[str, ...], int]:
    """The largest ``Conv_j`` index at each level (by parent path) of a
    flat Flax tree's paths."""
    last: dict[tuple[str, ...], int] = {}
    for path in paths:
        for i, comp in enumerate(path[:-1]):
            m = re.fullmatch(r"Conv_(\d+)", comp)
            if m:
                last[path[:i]] = max(last.get(path[:i], 0), int(m.group(1)))
    return last


def _torch_name(path: tuple[str, ...], last: dict) -> str:
    parts = []
    for i, comp in enumerate(path[:-1]):
        parent = path[i - 1] if i else ""
        m = re.fullmatch(r"(ConvBlock|Conv|Dense)_(\d+)", comp)
        if m:
            kind, k = m.groups()
            if kind == "ConvBlock":
                parts.append(f"blocks.{k}" if i == 0 else "block")
            elif kind == "Conv":
                parts.append(
                    f"convs.{k}" if _CONV_LISTS.fullmatch(parent) else
                    "conv" if _CONV_SINGLE.fullmatch(parent) else
                    "head" if int(k) == last[path[:i]] else f"convs.{k}")
            else:
                parts.append(f"mlp.{2 * int(k)}" if re.match(
                    r"ChannelGate_|SqueezeExcite_|AffineCoupling_", parent)
                    else "fc")
            continue
        for pat, rep in _TO_TORCH:
            if pat.fullmatch(comp):
                parts.append(pat.sub(rep, comp))
                break
        else:
            raise KeyError(f"no torch counterpart for Flax path {path}")
    return ".".join(parts + [_LEAVES[path[-1]]])


def _flax_path(name: str, net: torch.nn.Module) -> tuple[str, ...]:
    comps = name.split(".")
    setup = isinstance(net, (VaeNet, VaeFlowNet, ModelVae))
    path = []
    i = 0
    while i < len(comps) - 1:
        c = comps[i]
        if i == 0 and c in ("encoder", "decoder"):
            path.append(c if setup else f"{c.capitalize()}2D_0")
        elif _NAMED.fullmatch(c):
            path.append(c)
        elif c == "mlp":
            path.append(f"Dense_{int(comps[i + 1]) // 2}")
            i += 1
        elif c == "norms":
            layer = isinstance(net.get_submodule(".".join(comps[:i + 2])),
                               ChannelLayerNorm)
            path.append(f"{'Layer' if layer else 'Group'}Norm_{comps[i + 1]}")
            i += 1
        elif c in _LISTS:
            path.append(f"{_LISTS[c]}_{comps[i + 1]}")
            i += 1
        elif c == "head":
            # the output conv comes after the level's other convs
            convs = getattr(net.get_submodule(".".join(comps[:i])), "convs",
                            ())
            path.append(f"Conv_{len(convs)}")
        else:
            path.append(_SINGLE[c])
        i += 1
    leaf = comps[-1]
    if leaf == "weight":
        leaf = "scale" if re.search(r"Norm_\d+$", path[-1]) else "kernel"
    return tuple(path) + (leaf,)


def params_from_flax(flax_params) -> dict[str, torch.Tensor]:
    """Flax params tree -> PyTorch state_dict (float32 CPU tensors)."""
    if "params" in flax_params:
        flax_params = flax_params["params"]
    flat = list(_flat(flax_params))
    last = _last_convs(path for path, _ in flat)
    out = {}
    for path, v in flat:
        a = np.asarray(v, np.float32)
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        out[_torch_name(path, last)] = torch.tensor(a)
    return out


def params_to_flax(state_dict, net: torch.nn.Module) -> dict:
    """PyTorch state_dict -> Flax params tree ``{'params': {...}}`` of
    float32 numpy arrays.  ``net`` is the module the state dict belongs
    to."""
    tree: dict = {}
    for name, t in state_dict.items():
        a = t.detach().cpu().numpy().astype(np.float32)
        path = _flax_path(name, net)
        if path[-1] == "kernel":
            a = np.ascontiguousarray(a.transpose(2, 3, 1, 0) if a.ndim == 4
                                     else a.T)
        node = tree
        for comp in path[:-1]:
            node = node.setdefault(comp, {})
        node[path[-1]] = a
    return {"params": tree}


def npz_from_state_dict(state_dict,
                        net: torch.nn.Module) -> dict[str, np.ndarray]:
    """State dict -> {keystr path: array}, the JAX package's npz keys
    (``net`` as for :func:`params_to_flax`)."""
    flat = _flat(params_to_flax(state_dict, net))
    return {"".join(f"['{k}']" for k in path): a for path, a in flat}


def state_dict_from_npz(arrays) -> dict[str, torch.Tensor]:
    """Inverse of :func:`npz_from_state_dict`."""
    tree: dict = {}
    for key, a in arrays.items():
        path = _KEY.findall(key)
        node = tree
        for comp in path[:-1]:
            node = node.setdefault(comp, {})
        node[path[-1]] = a
    return params_from_flax(tree)
