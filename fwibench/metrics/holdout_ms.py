"""Milliseconds of one held-out misfit (``ElasticDIPEngine.
holdout_misfit``: a decode and the ring forward of the held-out shots),
the mean over the window's calls."""


def read(ctx):
    spans = ctx.spans.of("holdout", ctx.lo, ctx.hi)
    return 1e3 * sum(b - a for a, b in spans) / len(spans) if spans else None
