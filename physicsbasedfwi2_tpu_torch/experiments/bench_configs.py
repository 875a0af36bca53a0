"""End-to-end iteration wall-clock for every BASELINE.json config (port
of ``benchmarks/bench_configs.py``).

The harness drives the *engines* (net forward, physics gradient,
optimizer update, host logging): the number a user of the reference
experiences per ``optimize_parameters`` call
(trainValLatent4dVel2.py:51-75 ``iter_start_time`` timing).

Each line: {"config": ..., "workload": ..., "seconds_per_iteration": N,
"shots_per_sec": N, "mcell_steps_per_sec": N, "path": ..., "launches":
..., "device": ...} where mcell_steps_per_sec counts ONE
forward-equivalent pass (nz*nx*nt*shots/iter / wall-clock): gradient
iterations sweep the grid ~3x, so the hardware does ~3x this; the
single-pass convention keeps the number comparable across schemes with
different checkpointing.  ``path`` is the engine's ``physics_path``;
``launches`` the kernels' launches over the run, as [launches, resident,
per-step] by kernel; ``device`` the card's name and power limit.  A
config that raises prints its error row and the sweep goes on, but the
process then exits 1.

Usage:
    python -m physicsbasedfwi2_tpu_torch.experiments.bench_configs \\
        [--iters N] [--only NAME] [--small] [--device cpu]

Runs on the card unless ``--device`` names another device; ``--small``
(the CLIs' shrunk sizes) is for runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

from physicsbasedfwi2_tpu_torch.engine import create_engine, get_workload
from physicsbasedfwi2_tpu_torch.experiments.timing import (
    card, launch_counts, launches_since, resolve_device, wait,
)
from physicsbasedfwi2_tpu_torch.landscape.cli import small_overrides

# (BASELINE.json config name, workload registry name)
CONFIGS = [
    ("1_marmousi_acoustic_cnn_prior", "marmousi_acoustic"),
    ("2_acoustic_unet22", "marmousi_acoustic_unet"),
    ("3_marmousi_elastic_lbfgs", "marmousi_elastic_lbfgs"),
    ("4_vae_latent_inversion", "latent_inversion"),
    ("5_seam_elastic_mcdip", "mcdip_uq"),
]


def bench_one(workload: str, iters: int, *, device=None,
              **overrides) -> dict:
    """Seconds per physics-phase ``optimize_parameters`` of ``workload``'s
    engine (its config with ``overrides``) on ``device`` (default the
    card), after two warm-up calls, over ``iters`` calls."""
    cfg = get_workload(workload, name=f"bench_{workload}",
                       save_dir=os.path.join(tempfile.gettempdir(),
                                             "fwi_bench_ck"), **overrides)
    eng = create_engine(cfg, device=device)
    dev = eng.device
    # bench the PHYSICS-phase iteration: epochs must sit past any
    # lstart warmup (which trains the cheap anchor regression only)
    e0 = cfg.lstart + 1
    # the first call builds the engine's lazy state; the second warms it
    for _ in range(2):
        eng.optimize_parameters(epoch=e0)
    wait(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        eng.optimize_parameters(epoch=e0 + 1 + i)
    wait(dev)
    dt = (time.perf_counter() - t0) / iters
    shots = cfg.shots_per_iter or cfg.num_shots
    cells = cfg.nz * cfg.nx
    return {
        "seconds_per_iteration": round(dt, 5),
        "shots_per_sec": round(shots / dt, 2),
        "mcell_steps_per_sec": round(cells * cfg.nt * shots / dt / 1e6, 1),
        "path": eng.physics_path,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="End-to-end engine iteration per BASELINE config "
                    "(PyTorch port)")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--only", default=None,
                   help="bench a single workload registry name")
    p.add_argument("--small", action="store_true",
                   help="the CLIs' shrunk sizes (runs on the CPU)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; fails when "
                        "none is visible -- pass cpu to run the kernels' "
                        "plain versions on the CPU)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    device_line = card(dev)

    rows = ([(f"only_{args.only}", args.only)] if args.only
            else CONFIGS)
    failed = False
    for config_name, workload in rows:
        overrides = (small_overrides(
            get_workload(workload).engine == "elastic_dip")
            if args.small else {})
        before = launch_counts()
        try:
            r = bench_one(workload, args.iters, device=dev, **overrides)
        except Exception as e:  # keep the sweep alive per config
            traceback.print_exc()
            failed = True
            print(json.dumps({"config": config_name, "workload": workload,
                              "error": f"{type(e).__name__}: {e}",
                              "device": device_line}), flush=True)
            continue
        print(json.dumps({"config": config_name, "workload": workload,
                          **r, "launches": launches_since(before),
                          "device": device_line}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
