"""Seconds of set-up spent making the inputs and building the engine
(``data/synthetic.py``'s workload, ``create_engine``: the observed data
through the forward kernel, the direct wave, the validation twin, the
generator), the benchmark's span around them."""


def read(ctx):
    spans = ctx.spans.of("workload")
    return spans[0][1] - spans[0][0] if spans else None
