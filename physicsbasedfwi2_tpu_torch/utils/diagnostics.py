"""Gradient/parameter diagnostics (port of
``physicsbasedfwi2_tpu/utils/diagnostics.py``).

Capability-equivalents of the reference's NaN debugging aids:
``diagnose_network`` (mean |grad| per net) and the L-BFGS line search's
``is_legal`` NaN/Inf guard.

A "tree" is a tensor, a dict (a state dict, or nested dicts), a list or
tuple of them, or an ``nn.Module`` (its ``named_parameters``).
"""

from __future__ import annotations

from collections.abc import Mapping

import torch


def _leaves(tree, prefix=()):
    """(path, tensor) pairs of ``tree`` in order; a module's parameters
    by their ``named_parameters`` names."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, torch.as_tensor(tree)


def is_legal(tree) -> bool:
    """True iff every leaf is finite (the L-BFGS guard)."""
    return all(bool(torch.isfinite(leaf).all()) for _, leaf in _leaves(tree))


def grad_norms(grads) -> dict:
    """Per-leaf L2 norms keyed by path (diagnose_network role): a state
    dict's or module's leaves by the port's parameter names, nested
    dicts' by their keys joined with "/"."""
    return {"/".join(path): float(torch.linalg.vector_norm(
                leaf.detach().to(torch.float32)))
            for path, leaf in _leaves(grads)}


def diagnose_params(tree, name: str = "net") -> str:
    """Mean |value| + finiteness summary (printable)."""
    leaves = [leaf.detach() for _, leaf in _leaves(tree)]
    total = sum(float(torch.sum(torch.abs(leaf))) for leaf in leaves)
    count = sum(leaf.numel() for leaf in leaves)
    finite = is_legal(leaves)
    return (f"[{name}] mean|x|={total / max(count, 1):.3e} "
            f"params={count} finite={finite}")
