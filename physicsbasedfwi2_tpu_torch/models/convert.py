"""Carry generator weights between the Flax and PyTorch packages.

``params_from_flax`` maps a Flax ``AutoEncoderNet`` or
``ElasticAutoEncoderNet`` params tree (nested dicts of arrays, with or
without the top ``'params'`` level) to this package's ``state_dict``;
``params_to_flax`` is its inverse.  The elastic net's named submodules
(``combine_vx``, ``combine_vz``, ``decoder_field{k}``) keep their names
on both sides.  Layouts:

- conv kernels HWIO <-> OIHW;
- Dense kernels [in, out] <-> Linear weights [out, in] (the port
  flattens and unflattens in NHWC order, so no permutation of rows is
  needed);
- GroupNorm ``scale``/``bias`` <-> ``weight``/``bias``.

``npz_from_state_dict`` / ``state_dict_from_npz`` use the JAX package's
checkpoint keys (``jax.tree_util.keystr`` paths such as
``['params']['Encoder2D_0']['Dense_0']['kernel']``), so a
``<tag>_net_G.npz`` loads in either package.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# Flax submodule name -> torch attribute path, per path component
_TO_TORCH = [
    (re.compile(r"Encoder2D_0$"), "encoder"),
    (re.compile(r"Decoder2D_0$"), "decoder"),
    (re.compile(r"Down_(\d+)$"), r"downs.\1"),
    (re.compile(r"Up_(\d+)$"), r"ups.\1"),
    (re.compile(r"ConvBlock_0$"), "block"),
    (re.compile(r"GroupNorm_(\d+)$"), r"norms.\1"),
    (re.compile(r"Dense_0$"), "fc"),
    (re.compile(r"(combine_v[xz]|decoder_field\d+)$"), r"\1"),
]
_TO_FLAX = {"encoder": "Encoder2D_0", "decoder": "Decoder2D_0",
            "downs": "Down", "ups": "Up", "block": "ConvBlock_0",
            "norms": "GroupNorm", "convs": "Conv", "fc": "Dense_0",
            "head": "Conv_0"}
_NAMED = re.compile(r"combine_v[xz]|decoder_field\d+")
_KEY = re.compile(r"\['([^']*)'\]")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_name(path: tuple[str, ...]) -> str:
    parts = []
    for i, comp in enumerate(path[:-1]):
        m = re.fullmatch(r"Conv_(\d+)", comp)
        if m:
            # convs inside a ConvBlock; the decoder's own 1x1 head
            parts.append(f"convs.{m.group(1)}"
                         if i and path[i - 1] == "ConvBlock_0" else "head")
            continue
        for pat, rep in _TO_TORCH:
            if pat.fullmatch(comp):
                parts.append(pat.sub(rep, comp))
                break
        else:
            raise KeyError(f"no torch counterpart for Flax path {path}")
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]
    return ".".join(parts + [leaf])


def _flax_path(name: str) -> tuple[str, ...]:
    comps = name.split(".")
    path = []
    i = 0
    while i < len(comps) - 1:
        c = comps[i]
        if _NAMED.fullmatch(c):
            path.append(c)
            i += 1
            continue
        base = _TO_FLAX[c]
        if c in ("downs", "ups", "norms", "convs"):
            path.append(f"{base}_{comps[i + 1]}")
            i += 2
        else:
            path.append(base)
            i += 1
    leaf = comps[-1]
    if leaf == "weight":
        leaf = "scale" if path[-1].startswith("GroupNorm") else "kernel"
    return tuple(path) + (leaf,)


def params_from_flax(flax_params) -> dict[str, torch.Tensor]:
    """Flax params tree -> PyTorch state_dict (float32 CPU tensors)."""
    if "params" in flax_params:
        flax_params = flax_params["params"]
    out = {}
    for path, v in _flat(flax_params):
        a = np.asarray(v, np.float32)
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        out[_torch_name(path)] = torch.tensor(a)
    return out


def params_to_flax(state_dict) -> dict:
    """PyTorch state_dict -> Flax params tree ``{'params': {...}}`` of
    float32 numpy arrays."""
    tree: dict = {}
    for name, t in state_dict.items():
        a = t.detach().cpu().numpy().astype(np.float32)
        path = _flax_path(name)
        if path[-1] == "kernel":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = tree
        for comp in path[:-1]:
            node = node.setdefault(comp, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return {"params": tree}


def npz_from_state_dict(state_dict) -> dict[str, np.ndarray]:
    """State dict -> {keystr path: array}, the JAX package's npz keys."""
    flat = _flat(params_to_flax(state_dict))
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
