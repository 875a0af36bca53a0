"""Elastic FWI iteration benchmark, the DENISE workload (port of
``benchmarks/bench_elastic.py``).

Reference workload (BASELINE.md): 5 shots/iter x 5.0 s record x grid
~100x300 (dx=20 m), forward + adjoint per gradient, DENISE-Black-Edition
on 30 CPU MPI ranks (NPROCX=6 x NPROCY=5) with file-based coupling.  The
reference repo preserves no DENISE wall-clock numbers.  This harness
times the split-PML ``simulate_elastic``'s value and gradient under
autograd (plain PyTorch, no kernel) on ``bench.py``'s elastic case: one
warm chain, then 5 chained iterations, and reports the iteration
wall-clock and the FD cell-steps/s (forward + adjoint ~ 3 passes over
the padded grid).

Usage:
    python -m physicsbasedfwi2_tpu_torch.experiments.bench_elastic \\
        [--nt 3334] [--device cpu]

Runs on the card unless ``--device`` names another device; a cut
``--nt`` is for runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from physicsbasedfwi2_tpu_torch.experiments.bench import (
    build_elastic, elastic_value_and_grad, time_chain,
)
from physicsbasedfwi2_tpu_torch.experiments.timing import card, resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Split-PML elastic FWI iteration (PyTorch port)")
    p.add_argument("--nt", type=int, default=3334,
                   help="time steps (3334: a 5.0 s record)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; fails when "
                        "none is visible)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    case = build_elastic(nt=args.nt, device=dev)
    grid = case[0].grid
    ns = len(case[2][0])
    vg = elastic_value_and_grad("pml", case)
    dt_iter = time_chain(vg, (case[3], case[4]), 1e-3, 1, 5)

    # effective FD throughput: fwd+adjoint ~ 3 passes over the grid
    pad = grid.padded_shape
    cell_steps = ns * grid.nt * pad[0] * pad[1] * 3 / dt_iter
    print(json.dumps({
        "metric": "marmousi_elastic_fwi_iteration_wallclock",
        "value": round(dt_iter, 4),
        "unit": "s",
        "cell_steps_per_sec": f"{cell_steps:.3e}",
        "workload": f"{ns} shots x {grid.nt * grid.dt:.1f}s x "
                    f"{grid.nz}x{grid.nx} P-SV fwd+adjoint",
        "path": "pml",
        "device": card(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
