"""Milliseconds an epoch spends in the train loop outside the engine's
calls (``engine/train.py::train``: logs, images, checkpoints, plateau
and guard bookkeeping): the window's epochs less their
``optimize_parameters`` and ``test`` spans, per epoch."""


def read(ctx):
    inner = sum(b - a for name in ("optimize", "test")
                for a, b in ctx.spans.of(name, ctx.lo, ctx.hi))
    return 1e3 * (ctx.window_s - inner) / ctx.epochs
