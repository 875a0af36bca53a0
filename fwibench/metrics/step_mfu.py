"""The whole training step's share of the card's float32 peak, in %: the
epoch's counted flop (the physics kernel's scheme at the cell's shapes,
``fwibench/counts.py``, plus the generator's forward and backward and
the validation forward counted on the reference's layers) over the
traced epoch time times 67 TFLOP/s."""

from fwibench import counts


def read(ctx):
    shots = ctx.size["num_shots"]
    if ctx.size["physics"] == "elastic":
        shots = min(ctx.cfg.shots_per_iter or shots, shots)
    flop = counts.physics_flop(ctx.size, shots) + ctx.gen_flop
    return 100.0 * flop / ((ctx.window_s / ctx.epochs) * counts.PEAK_FLOPS)
