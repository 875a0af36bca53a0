#!/usr/bin/env python3
"""Readings of a cell's compared numbers that set its limits' upper
ends: the plain reference put in the program's place and computed in
the nearest precision below the configuration's (TF32 for float32 with
TF32 off), and planted faults, each against the float32 reference
on the same seed's inputs: ``half_shots`` (the misfit over every other
shot, the mean over those), ``grad_x2`` (the physics gradient doubled)
and ``obs_shift`` (the observed data one time step late).

    python3 fwibench/control.py --workload <cell> --seeds 1,2,3 \
        [--runs tf32,half_shots,grad_x2,obs_shift] [--out FILE]

One JSON line a seed and run on standard output (and appended to
``--out``).  The benchmark's own runs never run this; it needs a card
for the cell's sizes (``--device cpu`` runs it on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fwibench import inputs, run  # noqa: E402


def case_for(cell_name: str, seed: int, device, shrink=None):
    """The reference's inputs of ``cell_name`` at ``seed``, as a run
    makes them."""
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from fwibench.reference import generator
    bench = run.manifest()
    cell = run.cell_of(bench, cell_name)
    config = run.load_json(run.BENCH / "configs" / f"{cell['config']}.json")
    traffic = run.load_json(run.BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = run.load_json(run.BENCH / "limits" / f"{cell_name}.json")
    size, fields = run.sizes(config, traffic, shrink)
    s = inputs.seed_of(seed)
    cfg = get_workload(config["recipe"], **fields, seed=s, name=cell_name)
    n_cmp = limits["steps"]
    models = inputs.models(size, s)
    geom = inputs.acquisition(size)
    wav = inputs.ricker(size["freq"], size["nt"], size["dt"], device)
    weights = inputs.weights(generator.spec(run.arch_of(cfg, size)), s,
                             device)
    return run.reference_case(size, cfg, models, geom, wav, weights, device,
                              n_cmp), n_cmp


def readings(case: dict, n_cmp: int, ref: dict, anchor, name: str) -> dict:
    """The compared numbers of run ``name`` against the float32 reference
    ``ref``: ``tf32`` (the reference in TF32 in the program's place, its
    own anchor epochs, then the physics steps from the reference's anchor
    state, as a run of the program does), a fault of the steps
    (``half_shots``, ``grad_x2``), or ``obs_shift`` (the observed data one
    time step late; only ``obs``)."""
    from fwibench.reference import steps
    if name == "obs_shift":
        obs = ref["obs"]
        late = (tuple(steps.shift_one(o) for o in obs)
                if isinstance(obs, tuple) else steps.shift_one(obs))
        return {"obs": steps.obs_gap(late, obs)}
    precision, fault = ("tf32", None) if name == "tf32" else ("fp32", name)
    state = anchor["state_anchor"] if anchor else None
    other = steps.run(dict(case), n_cmp, precision, fault, from_state=state)
    nums = steps.numbers(other, ref)
    if case.get("hold") is not None:
        fc = case["config"]["freq_stages"][0]
        w = ref.get("w_anchor", ref["w0"])
        nums["lossH"] = steps.rel(
            steps.holdout_loss(case, w, fc, precision, fault),
            steps.holdout_loss(case, w, fc))
    return nums


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--runs", default="tf32,half_shots,grad_x2,obs_shift")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    from fwibench.reference import steps
    dev = torch.device(args.device)
    for seed in (int(x) for x in args.seeds.split(",")):
        case, n_cmp = case_for(args.workload, seed, dev)
        t0 = time.perf_counter()
        anchor = steps.anchor(case)
        ref = steps.run(case, n_cmp, anchor=anchor)
        t_ref = time.perf_counter() - t0
        for name in args.runs.split(","):
            nums = readings(case, n_cmp, ref, anchor, name)
            line = {"workload": args.workload, "seed": seed, "run": name,
                    "reference_s": t_ref, "numbers": nums}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
