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
import torch.autograd.forward_ad as fwAD
from torch.utils.checkpoint import checkpoint


def _run_chunk(step, n_carry, *args):
    carry, xs = tuple(args[:n_carry]), args[n_carry:]
    ys = []
    for k in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(x[k] for x in xs))
        ys.append(y)
    return (*carry, torch.stack(ys))


def _run_chunk_params(step, carry, xs, params):
    ys = []
    for k in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(x[k] for x in xs), params)
        ys.append(y)
    return (*carry, torch.stack(ys))


class _ChunkGraphs:
    """CUDA graphs of one scan's chunk, captured at their first use and
    replayed for every chunk (all chunks have one shape): the forward
    (:func:`_run_chunk_params`, no autograd) and the backward (the
    recompute under autograd and ``torch.autograd.grad``).  Replaying a
    chunk launches its kernels without the host's per-operation dispatch,
    which bounds the plain propagators on a card.  Each scan makes its
    own: the graphs read the tensors the step closes over by address."""

    def __init__(self):
        self.fwd = None
        self.bwd = None

    @staticmethod
    def _capture(fn):
        """(graph, fn's outputs as recorded), after one run of ``fn`` on
        a side stream (the warm-up a capture needs)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn()
        return graph, out

    def forward(self, step, carry, xs, params):
        if self.fwd is None:
            ins = [a.clone() for a in (*carry, *xs)]
            n = len(carry)
            graph, out = self._capture(lambda: _run_chunk_params(
                step, tuple(ins[:n]), tuple(ins[n:]), params))
            self.fwd = graph, ins, out
        graph, ins, out = self.fwd
        for dst, src in zip(ins, (*carry, *xs)):
            dst.copy_(src)
        graph.replay()
        return tuple(o.clone() for o in out)

    def backward(self, step, n, m, args, grads):
        if self.bwd is None:
            # the carry always takes a gradient (the first chunk's zeros
            # too), so that every chunk replays one graph
            ins = [a.detach().clone().requires_grad_(a.requires_grad or i < n)
                   for i, a in enumerate(args)]
            gs = [g.clone() for g in grads]
            want = [a for a in ins if a.requires_grad]

            def run():
                with torch.enable_grad():
                    outs = _run_chunk_params(step, tuple(ins[:n]),
                                             tuple(ins[n:n + m]),
                                             tuple(ins[n + m:]))
                return torch.autograd.grad(outs, want, gs,
                                           allow_unused=True)

            graph, out = self._capture(run)
            self.bwd = graph, ins, gs, out
        graph, ins, gs, out = self.bwd
        with torch.no_grad():
            for dst, src in zip((*ins, *gs), (*args, *grads)):
                dst.copy_(src)
        graph.replay()
        got = iter(None if g is None else g.clone() for g in out)
        return [next(got) if a.requires_grad else None for a in ins]


class _Chunk(torch.autograd.Function):
    """One chunk of steps whose forward keeps no graph: the backward
    recomputes the chunk from its saved carry, inputs and parameters
    (detached, so the recomputed graph is the chunk's own) and returns
    their gradients.  With ``graphs`` (CUDA tensors) both run as CUDA
    graph replays."""

    @staticmethod
    def forward(ctx, step, n_carry, n_xs, graphs, *args):
        ctx.step, ctx.n_carry, ctx.n_xs, ctx.graphs = (step, n_carry, n_xs,
                                                       graphs)
        ctx.save_for_backward(*args)
        carry, xs = args[:n_carry], args[n_carry:n_carry + n_xs]
        params = args[n_carry + n_xs:]
        if graphs is not None:
            return graphs.forward(step, carry, xs, params)
        return _run_chunk_params(step, carry, xs, params)

    @staticmethod
    def backward(ctx, *grads):
        n, m = ctx.n_carry, ctx.n_xs
        if ctx.graphs is not None:
            got = ctx.graphs.backward(ctx.step, n, m, ctx.saved_tensors,
                                      grads)
            return (None, None, None, None, *got)
        args = [a.detach().requires_grad_(a.requires_grad)
                for a in ctx.saved_tensors]
        with torch.enable_grad():
            outs = _run_chunk_params(ctx.step, tuple(args[:n]),
                                     tuple(args[n:n + m]),
                                     tuple(args[n + m:]))
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        want = [a for a in args if a.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                       [g for _, g in pairs],
                                       allow_unused=True) if pairs and want
                   else [None] * len(want))
        return (None, None, None, None,
                *(next(got) if a.requires_grad else None for a in args))


class _DualChunk(torch.autograd.Function):
    """The graph node of one chunk under forward over reverse, which
    keeps no tangent per step.

    ``args``: the chunk's n + 1 outputs (carry and ys) as a pass on dual
    tensors without autograd gave their primals; then the carry's n
    primals and n tangents, the m inputs, the k parameters' primals and
    k tangents (a tangent None where that tensor is not dual).  The
    forward returns the outputs and saves only the chunk's inputs.  The
    backward recomputes the chunk on dual tensors under autograd and
    returns dual gradients, whose tangents carry the Hessian-vector
    product.  (``torch.utils.checkpoint`` on dual tensors keeps the
    tangent of every tensor a step saves outside its hooks, so memory
    grows with nt; and a Function's forward runs with forward-mode AD
    off, hence the pass outside it.)"""

    @staticmethod
    def _duals(args, n, m, k):
        def dual(ps, ts):
            return tuple(p if t is None else fwAD.make_dual(p, t)
                         for p, t in zip(ps, ts))
        i = 2 * n + m
        return (dual(args[:n], args[n:2 * n]), tuple(args[2 * n:i]),
                dual(args[i:i + k], args[i + k:]))

    @staticmethod
    def forward(ctx, step, n, m, k, *args):
        ctx.step, ctx.sizes = step, (n, m, k)
        ctx.save_for_backward(*args[n + 1:])
        return tuple(o.view_as(o) for o in args[:n + 1])

    @staticmethod
    def backward(ctx, *grads):
        n, m, k = ctx.sizes
        # the primals become leaves; tangents stay constants
        primal = [i < n or 2 * n <= i < 2 * n + m + k
                  for i in range(2 * n + m + 2 * k)]
        args = [a.detach().requires_grad_(a.requires_grad) if p else a
                for a, p in zip(ctx.saved_tensors, primal)]
        with torch.enable_grad():
            outs = _run_chunk_params(ctx.step,
                                     *_DualChunk._duals(args, n, m, k))
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        want = [a for a, p in zip(args, primal) if p and a.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                       [g for _, g in pairs],
                                       allow_unused=True) if pairs and want
                   else [None] * len(want))
        return (None,) * (4 + n + 1) + tuple(
            next(got) if p and a.requires_grad else None
            for a, p in zip(args, primal))


def chunked_checkpoint_scan(step, carry, xs, *, chunk: int = 32,
                            params=None, cuda_graphs: bool = True):
    """``carry, ys = scan(step, carry, xs)`` with one checkpoint per
    chunk of steps.

    Args:
        step: ``(carry, x) -> (carry, y)``, or with ``params``
            ``(carry, x, params) -> (carry, y)``; ``carry`` a tuple of
            tensors, ``x`` a tuple of one slice of each of ``xs``, ``y``
            one tensor.
        carry: tuple of tensors.
        xs: tuple of tensors with equal leading dim nt.
        chunk: steps per checkpointed unit.
        params: None, or the tuple of every differentiable tensor the
            step reads besides its carry and inputs.  Each chunk then
            runs without autograd and is recomputed from its saved
            carry, inputs and ``params`` in the backward pass
            (:class:`_Chunk`): no per-step graph and no saved-tensor
            hooks in the forward pass, about half the host time of
            ``torch.utils.checkpoint`` (which ``params=None`` uses, and
            which also follows tensors the step closes over).  On CUDA
            tensors both passes of a chunk are captured once as CUDA
            graphs and replayed (:class:`_ChunkGraphs`), so the step must
            be capturable (no host sync); ``cuda_graphs=False`` runs
            the chunks without graphs (for a step whose collectives go
            through the host).  With ``params`` a tensor the step
            closes over gets no gradient.  Dual (forward-mode AD)
            tensors in the carry or ``params`` run the chunks as a
            plain loop without autograd, and under autograd (forward
            over reverse) as :class:`_DualChunk`, whose memory is two
            carries a chunk whatever the chunk's length; there a dual
            tensor the step closes over would keep its tangents, so the
            step must take every dual tensor it reads as ``params``.

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
    dual = any(fwAD.unpack_dual(a).tangent is not None
               for a in (*carry, *(params or ())))
    if dual and use_ckpt and params is None:
        raise ValueError("chunked_checkpoint_scan: forward over reverse "
                         "needs the step's tensors as params")
    graphs = (_ChunkGraphs() if params is not None and carry[0].is_cuda
              and cuda_graphs and not dual else None)
    ys = []
    for t0 in range(0, nt + pad, chunk):
        xc = tuple(x[t0: t0 + chunk] for x in xs)
        if params is not None:
            if use_ckpt and dual:
                with torch.no_grad():
                    out = [fwAD.unpack_dual(o) for o in
                           _run_chunk_params(step, carry, xc, params)]
                cp = [fwAD.unpack_dual(c) for c in carry]
                pp = [fwAD.unpack_dual(p) for p in params]
                prim = _DualChunk.apply(
                    step, n, len(xc), len(pp), *(o.primal for o in out),
                    *(c.primal for c in cp), *(c.tangent for c in cp), *xc,
                    *(p.primal for p in pp), *(p.tangent for p in pp))
                out = [p if o.tangent is None else fwAD.make_dual(p, o.tangent)
                       for p, o in zip(prim, out)]
            elif use_ckpt:
                out = _Chunk.apply(step, n, len(xc), graphs, *carry, *xc,
                                   *params)
            elif graphs is not None:
                out = graphs.forward(step, carry, xc, params)
            else:
                out = _run_chunk_params(step, carry, xc, params)
        elif use_ckpt:
            out = checkpoint(_run_chunk, step, n, *carry, *xc,
                             use_reentrant=False)
        else:
            out = _run_chunk(step, n, *carry, *xc)
        carry, y = tuple(out[:n]), out[n]
        ys.append(y)
    return carry, torch.cat(ys)[:nt]


def closure_scan(step, carry, xs, params, *, chunk: int = 32):
    """:func:`chunked_checkpoint_scan` of ``step(carry, x, params)`` with
    ``params`` closed over (``torch.utils.checkpoint`` under autograd:
    differentiable twice, gradients reach every tensor the step reads),
    except where a parameter is dual: there ``params`` go to the scan,
    whose :class:`_DualChunk` keeps no tangent per step under forward
    over reverse."""
    if any(fwAD.unpack_dual(p).tangent is not None for p in params):
        return chunked_checkpoint_scan(step, carry, xs, chunk=chunk,
                                       params=params)
    return chunked_checkpoint_scan(lambda c, x: step(c, x, params), carry,
                                   xs, chunk=chunk)
