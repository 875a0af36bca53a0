"""The references' time loops: a step function run over chunks of time
steps, and the gradient of the recorded traces by a checkpointed
reverse sweep (each chunk restored from its first state, recomputed and
differentiated by autograd).

On a card each chunk (and each chunk's forward and backward together)
is captured once as a CUDA graph and replayed with its inputs copied
in; on the CPU the same functions run eagerly.  A step may do nothing
that waits on the host: sources and receivers are ``scatter_add`` and
``gather`` on the flattened grid.
"""

from __future__ import annotations

import torch


class _Graphed:
    """``fn(*inputs) -> list of tensors`` captured as a CUDA graph over
    static copies of the inputs; a call copies its inputs in, replays,
    and returns clones of the outputs."""

    def __init__(self, fn, inputs):
        self.static = [x.detach().clone() for x in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn(*self.static)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(*self.static)

    def __call__(self, *inputs):
        for s, x in zip(self.static, inputs):
            s.copy_(x)
        self.graph.replay()
        return [o.clone() for o in self.out]


class Scan:
    """``step(state, params, amp_t) -> (state, record)`` over ``nt`` time
    steps in chunks of ``chunk``; ``state`` a list of fields, ``params``
    a list of tensors, ``amp_t`` [ns] the source amplitudes of a step,
    ``record`` [ns, nr].  ``grad_params`` flags the params that get
    gradients."""

    def __init__(self, step, chunk: int = 64):
        self.step = step
        self.chunk = chunk
        self.graphs: dict = {}

    def _fwd(self, n_state):
        def fn(*xs):
            state, params, amp = (list(xs[:n_state]), xs[n_state:-1], xs[-1])
            recs = []
            for t in range(amp.shape[1]):
                state, r = self.step(state, params, amp[:, t])
                recs.append(r)
            return [*state, torch.stack(recs, 1)]
        return fn

    def _fwd_bwd(self, n_state, n_params, flags):
        fwd = self._fwd(n_state)

        def fn(*xs):
            state = xs[:n_state]
            params = xs[n_state:n_state + n_params]
            amp = xs[n_state + n_params]
            cots = xs[n_state + n_params + 1:]
            with torch.enable_grad():
                s = [x.detach().requires_grad_() for x in state]
                p = [x.detach().requires_grad_(f) for x, f in
                     zip(params, flags)]
                a = amp.detach().requires_grad_()
                out = fwd(*s, *p, a)
                wrt = [*s, *(x for x, f in zip(p, flags) if f), a]
                gs = torch.autograd.grad(out, wrt, cots, allow_unused=True)
            return [torch.zeros_like(w) if g is None else g
                    for g, w in zip(gs, wrt)]
        return fn

    def _call(self, key, make, inputs):
        if inputs[0].device.type != "cuda":
            return make()(*inputs)
        if key not in self.graphs:
            self.graphs[key] = _Graphed(make(), inputs)
        return self.graphs[key](*inputs)

    def forward(self, state, params, amp):
        """(records [ns, nt, nr], the first state of every chunk)."""
        n_state = len(state)
        nt = amp.shape[1]
        k = self.chunk
        pad = -nt % k
        amp = torch.nn.functional.pad(amp, (0, pad))
        starts, recs = [], []
        for c in range(0, nt + pad, k):
            starts.append([x.clone() for x in state])
            out = self._call(("f", n_state, *amp.shape[:1], k,
                              *(tuple(p.shape) for p in params)),
                             lambda: self._fwd(n_state),
                             [*state, *params, amp[:, c: c + k]])
            state, r = out[:n_state], out[n_state]
            recs.append(r)
        return torch.cat(recs, 1)[:, :nt], starts

    def backward(self, starts, params, amp, g_recs, flags):
        """Gradients of sum(g_recs * records) w.r.t. the flagged params
        and the amplitudes, by the reverse sweep over the chunks."""
        n_state, n_params = len(starts[0]), len(params)
        nt = amp.shape[1]
        k = self.chunk
        pad = -nt % k
        amp = torch.nn.functional.pad(amp, (0, pad))
        g_recs = torch.nn.functional.pad(g_recs, (0, 0, 0, pad))
        g_state = [torch.zeros_like(x) for x in starts[0]]
        g_params = [torch.zeros_like(p) for p, f in zip(params, flags) if f]
        g_amp = torch.zeros_like(amp)
        key = ("b", n_state, amp.shape[0], k, tuple(flags),
               *(tuple(p.shape) for p in params))
        for i in reversed(range(len(starts))):
            c = i * k
            out = self._call(key, lambda: self._fwd_bwd(n_state, n_params,
                                                        flags),
                             [*starts[i], *params, amp[:, c: c + k],
                              *g_state, g_recs[:, c: c + k]])
            g_state = out[:n_state]
            for j, g in enumerate(out[n_state:-1]):
                g_params[j] += g
            g_amp[:, c: c + k] = out[-1]
        return g_params, g_amp[:, :nt]


class _Run(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scan, state, flags, amp, *params):
        recs, starts = scan.forward(state, list(params), amp)
        ctx.scan, ctx.starts, ctx.flags = scan, starts, flags
        ctx.save_for_backward(amp, *params)
        return recs

    @staticmethod
    def backward(ctx, g_recs):
        amp, *params = ctx.saved_tensors
        g_params, g_amp = ctx.scan.backward(ctx.starts, params, amp,
                                            g_recs.contiguous(), ctx.flags)
        it = iter(g_params)
        return (None, None, None, g_amp,
                *(next(it) if f else None for f in ctx.flags))


def run(scan: Scan, state, params, amp):
    """Records [ns, nt, nr] of the loop; differentiable in ``amp`` and in
    the params that require a gradient."""
    flags = tuple(bool(p.requires_grad) for p in params)
    if not torch.is_grad_enabled() or not (any(flags) or amp.requires_grad):
        return scan.forward(state, list(params), amp)[0]
    return _Run.apply(scan, state, flags, amp, *params)
