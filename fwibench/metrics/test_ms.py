"""Milliseconds of one validation call (``Engine.test``: a decode, the
model MSE and the model's copy to the host), the mean over the
window."""


def read(ctx):
    spans = ctx.spans.of("test", ctx.lo, ctx.hi)
    return 1e3 * sum(b - a for a, b in spans) / len(spans) if spans else None
