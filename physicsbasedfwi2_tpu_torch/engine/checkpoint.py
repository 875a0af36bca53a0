"""Full train-state checkpoints (port of
``physicsbasedfwi2_tpu/engine/checkpoint.py``, which uses orbax).

A checkpoint holds an engine's trained weights (its :attr:`weights`
module's ``state_dict``: the generator's, or classic FWI's grids, or the
latent), its optimizer's state and the epoch, in one ``torch.save`` file
of tensors, numbers, lists and dicts only: :func:`restore_engine` loads
it with ``weights_only=True``, so no pickled object is ever executed (the
JAX package avoids pickle for the same reason).  The optimizer's state is
``torch.optim``'s ``state_dict`` (Adam, and SGLD/SGHMC with their noise
generator's state), or the L-BFGS memory and line-search state of the
engines' L-BFGS.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.engine.engines import _Lbfgs
from physicsbasedfwi2_tpu_torch.optim.lbfgs import LbfgsOptState


def _plain(x):
    """An L-BFGS state field as tensors, numbers and lists."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x))
    if isinstance(x, tuple):
        return [_plain(v) for v in x]
    return x


def _typed(v, like):
    """Inverse of :func:`_plain`, to the types of the field ``like``."""
    if isinstance(like, torch.Tensor):
        return v.to(like.device)
    if isinstance(like, np.ndarray):
        return v.numpy().astype(like.dtype)
    if isinstance(like, np.generic):
        return like.dtype.type(v.item())
    if isinstance(like, tuple):
        return type(like)(*(_typed(a, b) for a, b in zip(v, like)))
    return type(like)(v)


def _opt_state(opt) -> dict:
    if isinstance(opt, _Lbfgs):
        return {"lbfgs": {f.name: _plain(getattr(opt.state, f.name))
                          for f in dataclasses.fields(LbfgsOptState)}}
    out = {"torch": opt.state_dict()}
    gen = getattr(opt, "generator", None)  # SGLD, SGHMC
    if gen is not None:
        out["generator"] = gen.get_state()
    return out


def _load_opt_state(opt, state: dict) -> None:
    if isinstance(opt, _Lbfgs):
        opt.state = LbfgsOptState(**{
            f.name: _typed(state["lbfgs"][f.name], getattr(opt.state, f.name))
            for f in dataclasses.fields(LbfgsOptState)})
        return
    opt.load_state_dict(state["torch"])
    if "generator" in state:
        opt.generator.set_state(state["generator"])


def save_engine(engine, path: str, *, epoch: int = 0) -> None:
    """Checkpoint ``engine``'s weights, optimizer state and ``epoch`` to
    the file ``path``."""
    torch.save({"params": engine.weights.state_dict(),
                "opt_state": _opt_state(engine.opt), "epoch": int(epoch)},
               path)


def restore_engine(engine, path: str) -> int:
    """Load a :func:`save_engine` checkpoint into ``engine`` (built from
    the same config: the weights and optimizer of the same shapes and
    kind); returns its epoch."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    engine.weights.load_state_dict(state["params"])
    _load_opt_state(engine.opt, state["opt_state"])
    return int(state["epoch"])
