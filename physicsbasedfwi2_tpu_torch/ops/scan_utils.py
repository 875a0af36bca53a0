"""Time-loop scaffolding: a chunked, rematerialized loop (port of
``physicsbasedfwi2_tpu/ops/scan_utils.py``).

Backprop through nt ~ 4000 steps cannot keep every wavefield.  The
loop runs in chunks of ``chunk`` steps, each under
``torch.utils.checkpoint.checkpoint``: autograd keeps only the carry
at each chunk boundary and recomputes one chunk at a time in the
backward pass, so memory is O(nt/chunk + chunk) states and the compute
twice the forward, as ``jax.checkpoint`` on the inner scan gives.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _run_chunk(step, n_carry, *args):
    carry, xs = tuple(args[:n_carry]), args[n_carry:]
    ys = []
    for k in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(x[k] for x in xs))
        ys.append(y)
    return (*carry, torch.stack(ys))


def chunked_checkpoint_scan(step, carry, xs, *, chunk: int = 32):
    """``carry, ys = scan(step, carry, xs)`` with one checkpoint per
    chunk of steps.

    Args:
        step: ``(carry, x) -> (carry, y)``; ``carry`` a tuple of
            tensors, ``x`` a tuple of one slice of each of ``xs``,
            ``y`` one tensor.
        carry: tuple of tensors.
        xs: tuple of tensors with equal leading dim nt.
        chunk: steps per checkpointed unit.

    Returns:
        (carry, ys), ys with leading dim nt.  As in the JAX package, xs
        are zero-padded to a whole number of chunks, so the carry is
        the one after the padded steps.  Without autograd the chunks
        simply run.
    """
    carry = tuple(carry)
    nt = xs[0].shape[0]
    pad = -nt % chunk
    xs = tuple(torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
               for x in xs)
    n = len(carry)
    use_ckpt = torch.is_grad_enabled()
    ys = []
    for t0 in range(0, nt + pad, chunk):
        xc = tuple(x[t0: t0 + chunk] for x in xs)
        if use_ckpt:
            out = checkpoint(_run_chunk, step, n, *carry, *xc,
                             use_reentrant=False)
        else:
            out = _run_chunk(step, n, *carry, *xc)
        carry, y = tuple(out[:n]), out[n]
        ys.append(y)
    return carry, torch.cat(ys)[:nt]
