"""Kernel B2's share of its roofline bound, in %: the bound of one call
(``fwibench/counts.py::b2`` at the cell's shapes, all its shots) over
the device time of one call, the window's ``csrc/scalar2.cu`` kernels
over its B2 launches."""

from fwibench import counts


def read(ctx):
    calls = ctx.launches.get("fwi_l1_loss_grad", [0])[0]
    if not calls:
        return None
    t = sum(b - a for n, a, b in ctx.in_window()
            if "scalar2" in ctx.hand_written(n))
    if t <= 0:
        return None
    shots = ctx.size["num_shots"]
    return 100.0 * counts.bound_s(*counts.b2(ctx.size, shots)) / (t / calls)
