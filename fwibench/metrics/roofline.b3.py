"""Kernel B3's share of its roofline bound, in %: the bound of one call
(``fwibench/counts.py::b3`` at the cell's shapes and shots a step) over
the device time of one call, the window's ``csrc/elastic.cu`` kernels
less the held-out ring forward's sweep (``el_fwd_resident`` without
checkpoints), over its B3 launches."""

from fwibench import counts


def _ring(name):
    return "el_fwd_resident<" in name and name.split(",")[1].strip() == "false"


def read(ctx):
    calls = ctx.launches.get("fused_elastic_loss_grad", [0])[0]
    if not calls:
        return None
    t = sum(b - a for n, a, b in ctx.in_window()
            if "elastic" in ctx.hand_written(n) and not _ring(n))
    if t <= 0:
        return None
    shots = min(ctx.cfg.shots_per_iter or ctx.size["num_shots"],
                ctx.size["num_shots"])
    return 100.0 * counts.bound_s(*counts.b3(ctx.size, shots)) / (t / calls)
